"""The zeta nibble-pair pipeline: the port (aesfhe_tpu_torch, on the CPU)
against the reference (aesfhe_tpu), residue for residue.

Default run, on the tiny profile with the reference's session keys
carried across by interop.py and the reference's fresh encryptions as
inputs: the committed LUT files, the engine's power basis and polynomial
evaluation, and each service function of the nibble pipeline.  Every
ciphertext must be torch.equal to the reference's, at the same level and
scale.  The reference's JAX compiles dominate their time (~1 s per new
level and op on the CPU), so the same functions on the test profile are
`slow`.

Also in the default run: both packages' ten-round segment-refresh schedule
over level arithmetic alone (which stage refreshes, bootstraps or cleanses,
at which level).

`slow` also: one forward and one inverse round through both packages on
deep and on prod_boot's primes at N=2^10, compared after every stage, and
the port's forward round on deep against the AES oracle; the refresh path:
the port's boot_tiny cipher through its bootstrap (3 rounds against the
oracle, 10 to FIPS-197 C.1), and on prod_boot's primes at N=2^10 one
segment-refreshed round stage by stage and ten rounds through both
packages with a shared recrypt in place of the bootstrap.

    python -m pytest tests/test_torch_zeta.py -q [-m slow -s]
"""
import json

import numpy as np
import pytest
import torch

from aesfhe_tpu.coeffs import generate as jgen
from aesfhe_tpu.core import keys as jkeys
from aesfhe_tpu.core import rns as jrns
from aesfhe_tpu.core.engine import Engine as JEngine
from aesfhe_tpu.core.keys import GaloisKeySet as JGaloisKeySet
from aesfhe_tpu.core.params import CKKSParams as JCKKSParams
from aesfhe_tpu.ops.mixcolumns_service import AESFHETransformer as JTransformer
from aesfhe_tpu.ops.mixcolumns_service import NibblePair as JPair
from aesfhe_tpu.ops.shiftrows_service import AESFHEShiftRows as JShiftRows
from aesfhe_tpu.ops.xor_service import EngineWrapper as JEngineWrapper
from aesfhe_tpu.ops.xor_service import XORService as JXORService
from aesfhe_tpu.ops import zeta as jzeta
from aesfhe_tpu.pipeline import AESFHE128 as JAES
from aesfhe_tpu.utils import aes_utils as jutils
from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.aes_tables import AES_SBOX, aes128_partial
from aesfhe_tpu_torch.aes_tables import mix_columns, shift_rows
from aesfhe_tpu_torch.coeffs import generate as tgen
from aesfhe_tpu_torch.context import EngineContext
from aesfhe_tpu_torch.core import rns as trns
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.params import CKKSParams, get_params
from aesfhe_tpu_torch.ops.mixcolumns_service import AESFHETransformer
from aesfhe_tpu_torch.ops.mixcolumns_service import NibblePair
from aesfhe_tpu_torch.ops.shiftrows_service import AESFHEShiftRows
from aesfhe_tpu_torch.ops.xor_service import EngineWrapper, XORService
from aesfhe_tpu_torch.ops import zeta as tzeta
from aesfhe_tpu_torch.ops.zeta import ZetaEncoder, phase_error, split_nibbles
from aesfhe_tpu_torch.pipeline import AESFHE128
from aesfhe_tpu_torch.utils import aes_utils as tutils

KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
SEED = 17


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _RefCtx:
    """A reference key family in EngineContext's shape, with a private copy
    of the rotation key dict."""

    def __init__(self, eng, sk, pk, rlk, conj, rot):
        self.engine = eng
        self.secret_key = sk
        self.public_key = pk
        self.relinearization_key = rlk
        self.conjugation_key = conj
        self.rotation_key = JGaloisKeySet(keys=dict(rot.keys))
        self.bootstrap_key = None


def _key(k):
    return interop.switch_key(np.asarray(k.b), np.asarray(k.a),
                              getattr(k, "cap", None), device="cpu")


def _port_wrap(jwrap, params) -> EngineWrapper:
    """The port's wrapper over the reference wrapper's keys."""
    sk = jwrap.secret_key
    ctx = EngineContext.from_keys(
        Engine(params, device="cpu"),
        secret=interop.secret_key(np.asarray(sk.s_eval), sk.s_coeff,
                                  device="cpu"),
        public=interop.public_key(np.asarray(jwrap.public_key.b),
                                  np.asarray(jwrap.public_key.a),
                                  device="cpu"),
        relin=_key(jwrap.relin_key), conj=_key(jwrap.conj_key),
        rotation=interop.galois_keys(
            {g: (np.asarray(k.b), np.asarray(k.a), k.cap)
             for g, k in jwrap.rot_key.keys.items()}, device="cpu"))
    return EngineWrapper(ctx=ctx)


def _u32(jdata) -> np.ndarray:
    """Reference residues as uint32 (a few of its sums hand back int32
    arrays with the same bits)."""
    a = np.asarray(jdata)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _ct(jct):
    return interop.ciphertext(_u32(jct.data), jct.scale, device="cpu")


def _same(tct, jct, what=""):
    assert tct.level == jct.level, what
    assert tct.scale == jct.scale, what
    assert torch.equal(tct.data, interop.to_tensor(_u32(jct.data),
                                                   device="cpu")), what


class _Side:
    """One package's wrapper and zeta services."""

    def __init__(self, wrap, xor_cls, tf_cls, sr_cls):
        self.wrap = wrap
        self.xs = xor_cls(wrap)
        self.tf = tf_cls(wrap, self.xs)
        self.sr = sr_cls(wrap, self.xs)


@pytest.fixture(scope="module",
                params=["tiny", pytest.param("test", marks=pytest.mark.slow)])
def sides(request):
    """(reference side, port side, fresh reference nibble ciphertexts and
    their plaintext nibbles, profile)."""
    E = request.getfixturevalue(f"{request.param}_engine")
    jwrap = JEngineWrapper(ctx=_RefCtx(E["eng"], E["sk"], E["pk"], E["rlk"],
                                       E["conj"], E["rot"]))
    twrap = _port_wrap(jwrap, get_params(request.param))
    sc = jwrap.engine.slot_count
    rng = np.random.default_rng(SEED)
    nib = rng.integers(0, 16, (2, sc), dtype=np.uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkeys, "_rng", np.random.default_rng(SEED))
        cts = [jwrap.encrypt(ZetaEncoder.to_zeta(v, 16)) for v in nib]
    j = _Side(jwrap, JXORService, JTransformer, JShiftRows)
    t = _Side(twrap, XORService, AESFHETransformer, AESFHEShiftRows)
    return j, t, cts, nib, request.param


def _decode16(wrap, ct, n):
    return ZetaEncoder.from_zeta(wrap.decrypt(ct), 16)[:n]


# --------------------------------------------------------------------------
# committed coefficient files

COEFF_FILES = sorted(p.name for p in tgen.COEFF_DIR.glob("*.json"))


def test_coeff_files_are_the_generators_output(tmp_path):
    """The committed files are exactly what the port's generator writes."""
    paths = tgen.generate_all(tmp_path)
    assert sorted(paths) == COEFF_FILES
    for name, path in paths.items():
        assert path.read_bytes() == (tgen.COEFF_DIR / name).read_bytes(), name


@pytest.mark.parametrize("name", COEFF_FILES)
def test_coeff_file_equals_reference(name):
    """Every entry of the port's LUT file equals the reference's."""
    mine = json.loads((tgen.COEFF_DIR / name).read_text())
    ref = json.loads((jgen.COEFF_DIR / name).read_text())
    assert mine == ref
    assert len(mine["entries"]) > 0


# --------------------------------------------------------------------------
# host codecs and layout

@pytest.mark.parametrize("modulus", [16, 256])
def test_zeta_codec_matches_reference(modulus):
    v = np.random.default_rng(modulus).integers(0, modulus, 4096)
    z = tzeta.zeta_encode(v, modulus)
    assert np.array_equal(z, jzeta.zeta_encode(v, modulus))
    noisy = z * np.exp(0.3j * np.pi / modulus *
                       np.random.default_rng(1).uniform(-1, 1, z.size))
    assert np.array_equal(tzeta.zeta_decode(noisy, modulus),
                          jzeta.zeta_decode(noisy, modulus))
    assert np.array_equal(tzeta.zeta_decode(noisy, modulus), v)
    assert phase_error(noisy, v, modulus) < 0.15
    assert phase_error(z, (v + 1) % modulus, modulus) == pytest.approx(1.0)
    b = v.astype(np.uint8)
    for got, want in zip(split_nibbles(b), jzeta.split_nibbles(b)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [0, 5, 16, 33])
def test_aes_utils_match_reference(n):
    data = bytes(range(n))
    padded = tutils.pkcs7_pad(data)
    assert padded == jutils.pkcs7_pad(data) and len(padded) % 16 == 0
    assert tutils.pkcs7_unpad(padded) == data
    assert tutils.chunk_bytes(padded) == jutils.chunk_bytes(padded)
    block = padded[:16]
    state = tutils.bytes_to_state(block)
    assert np.array_equal(state, jutils.bytes_to_state(block))
    assert tutils.state_to_bytes(state) == block
    with pytest.raises(ValueError, match="corrupt"):
        tutils.pkcs7_unpad(padded[:-1] + bytes([0]))


def test_trace_intermediates_match_oracle():
    """zeta_trace's plain per-stage values end at aes128_partial(., 1)."""
    from aesfhe_tpu_torch.keyexp import expand_key_128
    from aesfhe_tpu_torch.zeta_trace import intermediates
    state = np.random.default_rng(SEED).integers(0, 256, 256, dtype=np.uint8)
    v = intermediates(state, expand_key_128(KEY))
    assert np.array_equal(v["c1"], np.concatenate(
        [aes128_partial(state[b:b + 16], KEY, 1) for b in range(0, 256, 16)]))
    assert np.array_equal(v["s1"], AES_SBOX[v["a0"]])


def test_pack_blocks(sides):
    j, t, _, _, _ = sides
    taes = AESFHE128(t.wrap, t.xs, t.tf, t.sr, KEY)
    jaes = JAES(j.wrap, j.xs, j.tf, j.sr, KEY)
    data = bytes(range(48))
    flat, nblocks = taes.pack_blocks(data)
    jflat, jn = jaes.pack_blocks(data)
    assert nblocks == jn == 4 and np.array_equal(flat, jflat)
    with pytest.raises(ValueError, match="do not fit"):
        taes.pack_blocks(bytes(16 * taes.blocks_per_ct))


# --------------------------------------------------------------------------
# engine

def test_make_power_basis_and_evaluate_polynomial(sides):
    j, t, cts, _, _ = sides
    jeng, teng = j.wrap.engine, t.wrap.engine
    for degree, normalize in ((8, True), (5, False)):
        jb = jeng.make_power_basis(cts[0], degree, j.wrap.relin_key,
                                   normalize=normalize)
        tb = teng.make_power_basis(_ct(cts[0]), degree, t.wrap.relin_key,
                                   normalize=normalize)
        assert len(tb) == degree
        for k, (a, b) in enumerate(zip(tb, jb, strict=True)):
            _same(a, b, f"power {k + 1}, normalize={normalize}")
    coeffs = np.array([0.25 - 0.5j, 0.0, 1.5j, -0.75, 0.125 + 0.25j])
    _same(teng.evaluate_polynomial(_ct(cts[1]), coeffs, t.wrap.relin_key),
          jeng.evaluate_polynomial(cts[1], coeffs, j.wrap.relin_key))


# --------------------------------------------------------------------------
# XOR service

def test_build_power_basis(sides):
    j, t, cts, _, _ = sides
    jb = j.xs._build_power_basis(cts[0])
    tb = t.xs._build_power_basis(_ct(cts[0]))
    assert sorted(tb) == sorted(jb) == list(range(1, 16))
    for k in jb:
        _same(tb[k], jb[k], f"t^{k}")


def test_xor_cipher(sides):
    """4-bit XOR of two ciphertexts: the bilinear 16x16 LUT."""
    j, t, cts, nib, _ = sides
    out = t.xs.xor_cipher(_ct(cts[0]), _ct(cts[1]))
    _same(out, j.xs.xor_cipher(cts[0], cts[1]))
    n = nib.shape[1]
    assert np.array_equal(_decode16(t.wrap, out, n), nib[0] ^ nib[1])


def test_xor_with_plain_nibbles(sides):
    j, t, cts, nib, _ = sides
    key = np.random.default_rng(SEED + 1).integers(0, 16, 16, dtype=np.uint8)
    out = t.xs._xor_with_plain_nibbles(_ct(cts[0]), key)
    _same(out, j.xs._xor_with_plain_nibbles(cts[0], key))
    n = nib.shape[1]
    want = nib[0] ^ np.tile(key, n // 16)
    assert np.array_equal(_decode16(t.wrap, out, n), want)
    # the second call reads the weight plaintexts from the cache
    _same(t.xs._xor_with_plain_nibbles(_ct(cts[0]), key), out)


def test_cleanse(sides):
    j, t, cts, _, _ = sides
    _same(t.xs.cleanse(_ct(cts[1])), j.xs.cleanse(cts[1]))


def test_lift_lo_and_recombine_nibbles16(sides):
    j, t, cts, nib, _ = sides
    _same(t.xs.lift_lo(_ct(cts[1])), j.xs.lift_lo(cts[1]))
    byte = t.xs.recombine_nibbles16(_ct(cts[0]), _ct(cts[1]))
    _same(byte, j.xs.recombine_nibbles16(cts[0], cts[1]))
    n = nib.shape[1]
    got = ZetaEncoder.from_zeta(t.wrap.decrypt(byte), 256)[:n]
    assert np.array_equal(got, (nib[0] << 4) | nib[1])


# --------------------------------------------------------------------------
# ShiftRows and the GF multipliers

def test_shift_rows_simd(sides):
    j, t, cts, _, _ = sides
    for inverse in (False, True):
        _same(t.sr.shift_rows_simd(_ct(cts[0]), inverse=inverse),
              j.sr.shift_rows_simd(cts[0], inverse=inverse), f"inv={inverse}")


def test_gf_mul_pair(sides):
    """m (x) byte on nibble pairs: two 2D LUTs through bilinear_lut."""
    j, t, cts, nib, profile = sides
    tp = NibblePair(_ct(cts[0]), _ct(cts[1]))
    m = 2 if profile == "tiny" else 9
    out = t.tf._gf_mul_pair(tp, m)
    jout = j.tf._gf_mul_pair(JPair(cts[0], cts[1]), m)
    _same(out.hi, jout.hi, "hi")
    _same(out.lo, jout.lo, "lo")
    n = nib.shape[1]
    table = tgen.gf_table(m)
    want = table[(nib[0] << 4) | nib[1]]
    assert np.array_equal(_decode16(t.wrap, out.hi, n), want >> 4)
    assert np.array_equal(_decode16(t.wrap, out.lo, n), want & 0xF)


# --------------------------------------------------------------------------
# whole rounds (slow)

PROD_TWO_N = 1 << 17
PROD_SMALL = dict(n=1 << 10, max_level=54, scale_bits=27,
                  num_special_primes=8, secret_hamming=192)


def _prod_small_params():
    """prod_boot's prime chain on N = 2^10 in both packages (its primes are
    1 mod 2^17, hence NTT-friendly on the small ring too)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jrns, trns):
            def prod_primes(bits, two_n, count, skip=(),
                            _find=mod.find_ntt_primes):
                return _find(bits, PROD_TWO_N, count, skip)
            mp.setattr(mod, "find_ntt_primes", prod_primes)
        jp, tp = JCKKSParams(**PROD_SMALL), CKKSParams(**PROD_SMALL)
    assert tp.all_primes == get_params("prod_boot").all_primes == \
        jp.all_primes
    return jp, tp


def _round_sides(chain, request):
    """(reference AES, port AES) over one key family, with direct rotation
    keys for both merged shift-mix step sets."""
    if chain == "deep":
        E = request.getfixturevalue("deep_engine")
        eng, sk, pk, rlk, conj, rot = (E["eng"], E["sk"], E["pk"], E["rlk"],
                                       E["conj"], E["rot"])
        tparams = get_params("deep")
    else:
        jp, tparams = _prod_small_params()
        eng = JEngine(jp)
        sk = eng.create_secret_key()
        pk = eng.create_public_key(sk)
        rlk = eng.create_relinearization_key(sk)
        conj = eng.create_conjugation_key(sk)
        rot = JGaloisKeySet(keys={})
    jwrap = JEngineWrapper(ctx=_RefCtx(eng, sk, pk, rlk, conj, rot))
    jxs = JXORService(jwrap)
    jtf = JTransformer(jwrap, jxs)
    twrap = _port_wrap(jwrap, tparams)
    steps = set()
    for inverse in (False, True):
        steps |= set(AESFHETransformer(twrap, None).rotation_steps(inverse))
    jwrap.ensure_rotation_steps(sorted(steps))
    twrap = _port_wrap(jwrap, tparams)
    txs = XORService(twrap)
    jaes = JAES(jwrap, jxs, jtf, JShiftRows(jwrap, jxs), KEY)
    taes = AESFHE128(twrap, txs, AESFHETransformer(twrap, txs),
                     AESFHEShiftRows(twrap, txs), KEY)
    return jaes, taes


def _oracle(state, rks):
    """Plain intermediates of round 1: ARK0, SubBytes, ShiftRows+MixColumns,
    ARK1."""
    sc = len(state)
    a0 = state ^ np.tile(rks[0], sc // 16)
    s1 = AES_SBOX[a0]
    m1 = np.concatenate([mix_columns(shift_rows(s1[b:b + 16]))
                         for b in range(0, sc, 16)])
    return a0, s1, m1, m1 ^ np.tile(rks[1], sc // 16)


def _stages_equal(jaes, taes, jpair, stages, label):
    """Run `stages` [(tag, fn(aes, pair), plaintext)] through both
    packages from the reference pair; residues, level and scale equal after
    every stage.  Returns the last port pair."""
    tpair = NibblePair(_ct(jpair.hi), _ct(jpair.lo))
    delta = taes.eng.engine.params.scale
    print(f"\n{label}")
    for tag, fn, want in stages:
        jpair, tpair = fn(jaes, jpair), fn(taes, tpair)
        for jc, tc, part in ((jpair.hi, tpair.hi, "hi"),
                             (jpair.lo, tpair.lo, "lo")):
            _same(tc, jc, f"{label} {tag} {part}")
        hi, lo = split_nibbles(want)
        err = max(phase_error(taes.eng.decrypt(tpair.hi), hi),
                  phase_error(taes.eng.decrypt(tpair.lo), lo))
        bad = int(np.sum(taes.decrypt_state(tpair) != want))
        print(f"  {tag:10s} level {tpair.hi.level:2d}  scale/Delta "
              f"{tpair.hi.scale / delta:.6f}  phase error {err:.3e} steps  "
              f"wrong bytes {bad}", flush=True)
    return tpair


@pytest.mark.slow
@pytest.mark.parametrize("chain", ["deep", "prod_primes_n1024"])
def test_round_stages_match_reference(chain, request):
    """The forward round (ARK0, SubBytes+cleanse, merged ShiftRows+
    MixColumns, ARK1), then the inverse round from a fresh encryption of its
    output in the port's order, stage by stage through both packages; a
    chain with levels to spare (prod_boot's) first cleanses the fresh input.
    The port's encrypt_rounds and decrypt_rounds run exactly these stages."""
    jaes, taes = _round_sides(chain, request)
    sc = taes.eng.engine.slot_count
    state = np.random.default_rng(SEED).integers(0, 256, sc, dtype=np.uint8)
    a0, s1, m1, c1 = _oracle(state, taes.round_keys)
    assert np.array_equal(c1, np.concatenate(
        [aes128_partial(state[b:b + 16], KEY, 1) for b in range(0, sc, 16)]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkeys, "_rng", np.random.default_rng(SEED))
        jfwd = jaes.encrypt_state(state)
        jinv = jaes.encrypt_state(c1)

    def cleanse(a, p):
        return type(p)(a.xor.cleanse(p.hi), a.xor.cleanse(p.lo))

    spare = taes.input_cleanse_fits(jfwd.hi.level)
    assert spare == (chain != "deep")
    top = [("cleanse", cleanse)] if spare else []
    out = _stages_equal(jaes, taes, jfwd, [
        (tag, fn, state) for tag, fn in top] + [
        ("ark0", lambda a, p: a.add_round_key(p, 0), a0),
        ("sub+cl", lambda a, p: a.sub_bytes(p), s1),
        ("shift-mix", lambda a, p: a.shift_mix(p), m1),
        ("ark1", lambda a, p: a.add_round_key(p, 1), c1)],
        f"{chain}: forward round")
    assert np.array_equal(taes.decrypt_state(out), c1)
    back = _stages_equal(jaes, taes, jinv, [
        (tag, fn, c1) for tag, fn in top] + [
        ("ark1", lambda a, p: a.add_round_key(p, 1), m1),
        ("cleanse", cleanse, m1),
        ("inv-mix", lambda a, p: a.shift_mix(p, inverse=True), s1),
        ("inv-sub", lambda a, p: a.sub_bytes(p, inverse=True,
                                             cleanse=False), a0),
        ("ark0", lambda a, p: a.add_round_key(p, 0), state)],
        f"{chain}: inverse round")
    assert np.array_equal(taes.decrypt_state(back), state)
    for run, jin, want in ((taes.encrypt_rounds, jfwd, out),
                           (taes.decrypt_rounds, jinv, back)):
        got = run(NibblePair(_ct(jin.hi), _ct(jin.lo)), rounds=1)
        assert torch.equal(got.hi.data, want.hi.data)
        assert torch.equal(got.lo.data, want.lo.data)


@pytest.mark.slow
def test_port_round_matches_oracle(request):
    """One forward round of the port alone on deep, from the reference's
    fresh ciphertexts and keys, against the AES oracle."""
    _, taes = _round_sides("deep", request)
    sc = taes.eng.engine.slot_count
    state = np.random.default_rng(SEED + 2).integers(0, 256, sc,
                                                     dtype=np.uint8)
    pair = taes.encrypt_state(state)
    teng = taes.eng.engine
    teng.reset_counters()
    out = taes.encrypt_rounds(pair, rounds=1)
    want = np.concatenate([aes128_partial(state[b:b + 16], KEY, 1)
                           for b in range(0, sc, 16)])
    assert np.array_equal(taes.decrypt_state(out), want)
    assert teng.counters["keyswitch"] == 350


@pytest.mark.slow
def test_byte_domain_services_match_reference(hp_engine):
    """The zeta256 byte-domain services on hp (2^52 scale, for degree-255
    LUTs): SubBytes (ladder basis and BSGS), a GF multiplier and the nibble
    extraction, residue for residue, and the values they decode to."""
    from aesfhe_tpu.ops.gf_service import GFService as JGF
    from aesfhe_tpu.ops.sbox_service import SBoxService as JSBox
    from aesfhe_tpu_torch.ops.gf_service import GFService
    from aesfhe_tpu_torch.ops.sbox_service import SBoxService
    E = hp_engine
    jwrap = JEngineWrapper(ctx=_RefCtx(E["eng"], E["sk"], E["pk"], E["rlk"],
                                       E["conj"], E["rot"]))
    twrap = _port_wrap(jwrap, get_params("hp"))
    sc = jwrap.engine.slot_count
    x = np.random.default_rng(SEED).integers(0, 256, sc, dtype=np.uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkeys, "_rng", np.random.default_rng(SEED))
        jct = jwrap.encrypt(ZetaEncoder.to_zeta(x, 256))
    tct = _ct(jct)

    def byte(ct):
        return ZetaEncoder.from_zeta(twrap.decrypt(ct), 256)

    jsb, tsb = JSBox(jwrap), SBoxService(twrap)
    out = tsb.sub_bytes_array(tct)
    _same(out, jsb.sub_bytes_array(jct), "sub_bytes_array")
    assert np.array_equal(byte(out), AES_SBOX[x])
    out = tsb.sub_bytes_array_bsgs(tct)
    _same(out, jsb.sub_bytes_array_bsgs(jct), "sub_bytes_array_bsgs")
    assert np.array_equal(byte(out), AES_SBOX[x])
    out = GFService(twrap).mul_byte(tct, 3)
    _same(out, JGF(jwrap).mul_byte(jct, 3), "mul_byte(3)")
    assert np.array_equal(byte(out), tgen.gf_table(3)[x])
    hi, lo = XORService(twrap).extract_nibbles(tct)
    jhi, jlo = JXORService(jwrap).extract_nibbles(jct)
    _same(hi, jhi, "extract_nibbles hi")
    _same(lo, jlo, "extract_nibbles lo")
    assert np.array_equal(_decode16(twrap, hi, sc), x >> 4)
    assert np.array_equal(_decode16(twrap, lo, sc), x & 0xF)


# --------------------------------------------------------------------------
# the segment-refresh schedule of ten rounds (level arithmetic only)

# Levels each stage consumes after a refresh on prod_boot's chain, and the
# bootstrap's exit level there, as the real ops give them on prod_boot's
# primes (the ten-round leg of chip_smoke.py on the card; on the CPU, the
# port's rounds at N=2^10 with a recrypt refresh, test below): a plain-key
# XOR 5, a power basis 4, an S-box LUT 4, a GF(2) LUT 3, GF(3) 4 (hi) and
# 3 (lo), the masked rotations 1, a nibble XOR 6, a cleanse 6, a ShiftRows
# mask 1.  Higher up the chain some stages take a level less, so this
# model's round 1 bootstraps 6 times where the real one does 11; rounds
# 2-10 start at level 3 and match it.
BOOT_EXIT = 20
LUT_DEPTH = {"sbox_hi2d": 4, "sbox_lo2d": 4, "gf2_hi2d": 3, "gf2_lo2d": 3,
             "gf3_hi2d": 4, "gf3_lo2d": 3}


class _Lvl:
    """A ciphertext reduced to its level."""

    def __init__(self, level):
        self.level = level
        self.scale = 1.0


def _level_cipher(pkg):
    """(cipher, event log) for one package: its own AESFHE128,
    XORService, AESFHETransformer and segment schedule over level-only
    stand-ins for the arithmetic; the refresh and the XOR's own bootstrap
    record the level they were called at and return BOOT_EXIT."""
    from types import SimpleNamespace
    if pkg == "ref":
        cls = (JAES, JXORService, JTransformer, JShiftRows)
    else:
        cls = (AESFHE128, XORService, AESFHETransformer, AESFHEShiftRows)
    aes_cls, xs_cls, tf_cls, sr_cls = cls
    log = []

    def boot(kind):
        def f(ct):
            log.append((kind, ct.level))
            return _Lvl(BOOT_EXIT)
        return f

    def spend(ct, d):
        if ct.level < d:
            raise RuntimeError("out of levels: bootstrap required")
        return _Lvl(ct.level - d)

    eng = SimpleNamespace(params=SimpleNamespace(rescale_primes=1),
                          slot_count=16, use_bootstrap=True)
    wrap = SimpleNamespace(engine=eng, boot_key=True,
                           bootstrap=boot("xor-boot"))
    xs = xs_cls(wrap)
    tf = tf_cls(wrap, xs)
    sr = sr_cls.__new__(sr_cls)
    aes = aes_cls(wrap, xs, tf, sr, KEY, refresh=boot("refresh"))
    aes.segment_refresh = True
    aes.post_boot_cleanses = 2
    names = {}
    for caches in [aes._sbox2d] + [tf._gf2d[m] for m in (2, 3)]:
        for c in caches:
            names[id(c.load_coeffs())] = c.path.name.split("_coeffs")[0]

    def cleanse(ct, modulus=16):
        log.append(("cleanse", ct.level))
        return spend(ct, 6)

    def mix_terms(tms, matrix, inverse):
        low = min(c.level for p in tms.values() for c in p)
        return [NibblePair(_Lvl(low - 1), _Lvl(low - 1)) for _ in range(4)]

    xs._xor_with_plain_nibbles = lambda ct, k: spend(ct, 5)
    xs._build_power_basis = lambda ct: {1: spend(ct, 4)}
    xs.cleanse = cleanse
    xs._lut2d_cipher = lambda a, b, basis, coeffs: spend(
        _Lvl(min(a.level, b.level)), 6)
    tf._bilinear = lambda bx, by, coeffs: spend(
        _Lvl(min(bx[1].level, by[1].level)), LUT_DEPTH[names[id(coeffs)]])
    tf._mix_terms = mix_terms
    sr.shift_rows_simd = lambda ct, inverse=False: spend(ct, 1)
    ark = aes.add_round_key

    def add_round_key(pair, r):
        log.append(("ark", r))
        return ark(pair, r)

    aes.add_round_key = add_round_key
    return aes, log


def _rounds(log):
    """The events of each round (between two AddRoundKeys)."""
    out, cur = [], []
    for ev in log:
        if ev[0] == "ark":
            out.append(cur)
            cur = []
        else:
            cur.append(ev)
    return out[1:]


def test_segment_schedule_matches_reference_over_ten_rounds():
    """Both packages' encrypt_rounds(rounds=10) in segment mode over the
    level arithmetic above, from a fresh pair at prod_boot's top level 54:
    the same refreshes, XOR bootstraps and cleanses at the same levels in
    every round (the port first cleanses the fresh input, so the reference
    starts from that cleansed pair).  In round 10 the reference's ShiftRows
    finds a nibble at level 0 and raises; the port refreshes it first."""
    taes, tlog = _level_cipher("port")
    jaes, jlog = _level_cipher("ref")
    out = taes.encrypt_rounds(NibblePair(_Lvl(54), _Lvl(54)), rounds=10)
    assert tlog[:2] == [("cleanse", 54)] * 2
    with pytest.raises(RuntimeError, match="out of levels"):
        jaes.encrypt_rounds(NibblePair(_Lvl(48), _Lvl(48)), rounds=10)
    trounds, jrounds = _rounds(tlog[2:]), _rounds(jlog + [("ark", 10)])
    assert len(trounds) == len(jrounds) == 10
    assert trounds[:9] == jrounds[:9]
    # round 10: the same events up to the raise, then the port's refresh
    # of the level-0 pair before ShiftRows
    n = len(jrounds[9])
    assert trounds[9][:n] == jrounds[9]
    assert [e for e in trounds[9][n:] if e[0] != "cleanse"][:2] == \
        [("refresh", 0)] * 2
    boots = [sum(e[0] != "cleanse" for e in r) for r in trounds]
    print(f"\nbootstraps per round (refreshes + XOR inputs): {boots}, "
          f"{sum(boots)} in all; exit level {out.hi.level}")
    # rounds 2-9 repeat the card's measured pattern: before SubBytes at 3,
    # the shift-mix's input at 0, its GF multiples at 1/1 and 0/1, eight
    # XOR inputs at 7, before AddRoundKey at 2
    steady = ([("refresh", 3)] * 2 + [("refresh", 0)] * 2
              + [("refresh", 1)] * 2 + [("refresh", 0), ("refresh", 1)]
              + [("xor-boot", 7)] * 8 + [("refresh", 2)] * 2)
    for r in trounds[1:9]:
        assert [e for e in r if e[0] != "cleanse"] == steady
    assert boots[1:9] == [18] * 8


# --------------------------------------------------------------------------
# slow: the refresh path with real bootstraps (boot_tiny) and, on prod_boot's
# primes at N=2^10, the segment schedule through both packages

FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS_CT = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")


@pytest.fixture(scope="module")
def boot_tiny_cipher():
    """The port's boot_tiny zeta cipher refreshed by its bootstrap between
    rounds, as the reference's tests/test_pipeline.py boot_cipher."""
    from aesfhe_tpu_torch import zeta_trace
    wrap, (xs, tf, sr), _ = zeta_trace.setup("boot_tiny", SEED, "cpu",
                                             bootstrap=True)
    return AESFHE128(wrap, xs, tf, sr, KEY, refresh=wrap.bootstrap)


@pytest.mark.slow
@pytest.mark.parametrize("rounds", [3, 10])
def test_boot_tiny_rounds_with_bootstrap(boot_tiny_cipher, rounds):
    """3 rounds against the AES oracle, and all 10 to FIPS-197 C.1 in
    every block, through real bootstraps."""
    aes = boot_tiny_cipher
    eng = aes.eng.engine
    sc = eng.slot_count
    if rounds == 10:
        state = np.tile(np.frombuffer(FIPS_PT, dtype=np.uint8), sc // 16)
        want = np.tile(np.frombuffer(FIPS_CT, dtype=np.uint8), sc // 16)
    else:
        state = np.random.default_rng(7).integers(0, 256, sc, dtype=np.uint8)
        want = np.concatenate([aes128_partial(state[b:b + 16], KEY, rounds)
                               for b in range(0, sc, 16)])
    eng.reset_counters()
    out = aes.encrypt_rounds(aes.encrypt_state(state), rounds=rounds)
    print(f"\nboot_tiny, {rounds} rounds: {eng.counters['bootstrap']} "
          f"bootstraps, exit level {out.hi.level}")
    assert eng.counters["bootstrap"] > 0
    assert np.array_equal(aes.decrypt_state(out), want)


class _Recrypt:
    """A refresh both packages can share: decrypt with the reference,
    encrypt the slots afresh (the reference's encryption, seeded by the
    call's index within its package) and drop to BOOT_EXIT, prod_boot's
    bootstrap exit level; the same input gives the same output in either
    package.  (A real bootstrap on prod_boot's primes at N=2^10 raises in
    EvalMod in both packages: tests/test_torch_fused_boot.py.)  Records
    every input as (residues, level, scale)."""

    def __init__(self, jwrap):
        self.jwrap = jwrap
        self.seen = {"ref": [], "port": []}

    def __call__(self, side):
        from aesfhe_tpu.core.ciphertext import Ciphertext as JCiphertext
        import jax.numpy as jnp

        def refresh(ct):
            data = (interop.to_numpy(ct.data) if side == "port"
                    else _u32(ct.data))
            k = len(self.seen[side])
            self.seen[side].append((data, ct.level, ct.scale))
            jw = self.jwrap
            v = jw.decrypt(JCiphertext(jnp.asarray(data), ct.scale))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jkeys, "_rng", np.random.default_rng((SEED, k)))
                fresh = jw.engine._drop(jw.encrypt(v), BOOT_EXIT)
            return fresh if side == "ref" else _ct(fresh)
        return refresh


@pytest.fixture(scope="module")
def seg_sides(request):
    """(reference AES, port AES, recrypt) on prod_boot's primes at N=2^10
    in the segment schedule (post_boot_cleanses=2), both refreshed by the
    shared recrypt, both bootstrapping low XOR inputs through it (the
    reference's use_bootstrap, the port's bootstrap key)."""
    jaes, taes = _round_sides("prod_primes_n1024", request)
    rec = _Recrypt(jaes.eng)
    jaes.eng.engine.use_bootstrap = True
    taes.eng.boot_key = True
    for side, aes in (("ref", jaes), ("port", taes)):
        aes.eng.bootstrap = aes.refresh = rec(side)
        aes.segment_refresh = True
        aes.post_boot_cleanses = 2
    return jaes, taes, rec


def _same_inputs(rec, n=None):
    """The refreshes' inputs, pairwise equal across the packages."""
    ref, port = rec.seen["ref"], rec.seen["port"]
    n = len(ref) if n is None else n
    assert len(ref) >= n and len(port) >= n
    for k, ((jd, jl, js), (td, tl, ts)) in enumerate(zip(ref[:n], port[:n])):
        assert (jl, js) == (tl, ts), f"refresh {k}"
        assert np.array_equal(jd, td), f"refresh {k}"
    return n


@pytest.mark.slow
def test_segment_round_stages_match_reference(seg_sides):
    """One segment-refreshed round, stage by stage through both packages
    (each stage's refreshes and cleanses included), every refresh input
    equal; then encrypt_rounds(rounds=1) whole, the reference given the
    cleansed input the port makes itself (its logged departure)."""
    jaes, taes, rec = seg_sides
    sc = taes.eng.engine.slot_count
    state = np.random.default_rng(SEED).integers(0, 256, sc, dtype=np.uint8)
    a0, s1, m1, c1 = _oracle(state, taes.round_keys)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkeys, "_rng", np.random.default_rng(SEED))
        jfwd = jaes.encrypt_state(state)
    seg = taes.SEG_STAGE_DEPTH

    def cleanse(a, p):
        return type(p)(a.xor.cleanse(p.hi), a.xor.cleanse(p.lo))

    out = _stages_equal(jaes, taes, jfwd, [
        ("cleanse", cleanse, state),
        ("ark0", lambda a, p: a.add_round_key(p, 0), a0),
        ("refresh", lambda a, p: a._refresh(p, seg), a0),
        ("sub", lambda a, p: a.sub_bytes(p, cleanse=False), s1),
        ("shift-mix", lambda a, p: a.shift_mix(p), m1),
        ("refresh", lambda a, p: a._refresh(p, seg), m1),
        ("ark1", lambda a, p: a.add_round_key(p, 1), c1)],
        "prod_primes_n1024: segment round")
    assert np.array_equal(taes.decrypt_state(out), c1)
    n = _same_inputs(rec)
    assert n == len(rec.seen["port"]) > 0
    jin = cleanse(jaes, jfwd)
    got = taes.encrypt_rounds(NibblePair(_ct(jfwd.hi), _ct(jfwd.lo)), 1)
    want = jaes.encrypt_rounds(jin, 1)
    _same(got.hi, want.hi, "whole round hi")
    _same(got.lo, want.lo, "whole round lo")
    _same_inputs(rec)
    print(f"{n} refreshes in the round")


@pytest.mark.slow
def test_segment_ten_rounds_on_prod_primes(seg_sides):
    """encrypt_rounds(rounds=10) in the segment schedule through both
    packages, every refresh input equal: the reference raises "out of
    levels" at round 10's ShiftRows (its SubBytes ends at level 0 and
    nothing refreshes it); the port refreshes there, and every block equals
    aes128_partial(block, key, 10), block 0 FIPS-197 C.1."""
    jaes, taes, rec = seg_sides
    for side in rec.seen:
        rec.seen[side].clear()
    sc = taes.eng.engine.slot_count
    state = np.random.default_rng(SEED + 1).integers(0, 256, sc,
                                                     dtype=np.uint8)
    state[:16] = np.frombuffer(FIPS_PT, dtype=np.uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkeys, "_rng", np.random.default_rng(SEED + 1))
        jpair = jaes.encrypt_state(state)
    tpair = NibblePair(_ct(jpair.hi), _ct(jpair.lo))
    jpair = type(jpair)(jaes.xor.cleanse(jpair.hi), jaes.xor.cleanse(jpair.lo))
    with pytest.raises(RuntimeError, match="out of levels"):
        jaes.encrypt_rounds(jpair, rounds=10)
    out = taes.encrypt_rounds(tpair, rounds=10)
    n = _same_inputs(rec)
    extra = rec.seen["port"][n:]
    assert [lvl for _, lvl, _ in extra][:2] == [0, 0]
    got = taes.decrypt_state(out)
    want = np.concatenate([aes128_partial(state[b:b + 16], KEY, 10)
                           for b in range(0, sc, 16)])
    assert np.array_equal(got, want)
    assert bytes(got[:16]) == FIPS_CT
    print(f"\n{len(rec.seen['port'])} refreshes over ten rounds, the "
          f"reference's first {n} equal; the port's round 10 adds "
          f"{len(extra)} from the level-0 ShiftRows")
