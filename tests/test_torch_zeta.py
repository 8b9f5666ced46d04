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

`slow` also: one forward and one inverse round through both packages on
deep and on prod_boot's primes at N=2^10, compared after every stage, and
the port's forward round on deep against the AES oracle.

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
