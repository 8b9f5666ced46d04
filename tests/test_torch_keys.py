"""Seeded keygen and encryption of the port against the reference on the
tiny profile (bit for bit: the same numpy draws in the same order, the
port's own NTT), and the c64 device encode/decode by value."""
import numpy as np
import pytest
import torch

from aesfhe_tpu.core import dev_encoding as jdev
from aesfhe_tpu.core import keys as jkeys
from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.core import dev_encoding as tdev
from aesfhe_tpu_torch.core import encoding, rns
from aesfhe_tpu_torch.core import engine as tengine
from aesfhe_tpu_torch.core import keys as tkeys
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.params import get_params


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Several test workers share the cores, and torch's default pool of one
    thread per core then stalls in its barriers; two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SEED = 1234


def _same(got: torch.Tensor, want):
    assert torch.equal(got, interop.to_tensor(np.asarray(want), device="cpu"))


@pytest.fixture(scope="module")
def jeng(tiny_engine):
    return tiny_engine["eng"]


def test_seeded_keygen_and_encrypt(jeng, monkeypatch):
    """secret, public, relin, one Galois key, one capped Galois key, then a
    host-path encryption, all from one seed on both sides."""
    monkeypatch.setattr(jkeys, "_rng", np.random.default_rng(SEED))
    jp, jt = jeng.params, jeng.tabs
    j_sk = jkeys.gen_secret_key(jp, jt)
    j_pk = jkeys.gen_public_key(jp, jt, j_sk)
    j_rlk = jkeys.gen_relin_key(jp, jt, j_sk)
    g = jp.rot_galois_elt(5)
    j_gk = jkeys.gen_galois_key(jp, jt, j_sk, g)
    j_cap = jkeys.gen_galois_key(jp, jt, j_sk, jp.conj_galois_elt, lvl_cap=3)
    x = np.random.default_rng(7).uniform(-1, 1, jp.slot_count)
    j_ct = jeng.encrypt(x, j_pk)

    teng = Engine(get_params("tiny"), device="cpu",
                  rng=np.random.default_rng(SEED))
    p, tt, rng = teng.params, teng.tabs, teng.rng
    t_sk = teng.create_secret_key()
    t_pk = teng.create_public_key(t_sk)
    t_rlk = teng.create_relinearization_key(t_sk)
    t_gk = tkeys.gen_galois_key(p, tt, t_sk, g, rng)
    t_cap = tkeys.gen_galois_key(p, tt, t_sk, p.conj_galois_elt, rng,
                                 lvl_cap=3)
    t_ct = teng.encrypt(x, t_pk)

    _same(t_sk.s_eval, j_sk.s_eval)
    assert np.array_equal(t_sk.s_coeff, j_sk.s_coeff)
    _same(t_pk.b, j_pk.b)
    _same(t_pk.a, j_pk.a)
    for tk, jk in ((t_rlk, j_rlk), (t_gk, j_gk), (t_cap, j_cap)):
        assert tk.cap == jk.cap
        _same(tk.b, jk.b)
        _same(tk.a, jk.a)
    assert t_cap.b.shape == (2, 3 + 1 + p.num_special, p.n)
    _same(t_ct.data, j_ct.data)
    assert t_ct.scale == j_ct.scale
    got = teng.decrypt(t_ct, t_sk)
    assert np.array_equal(got, jeng.decrypt(j_ct, j_sk))


def test_device_encode_decode_by_value(tiny_engine):
    """The c64 FFT encode/decode agree with the reference's by value: both
    round in complex64, in different orders, so residues may differ by a
    few coefficient units while decoded slots agree to ~1e-5."""
    jeng = tiny_engine["eng"]
    teng = Engine(get_params("tiny"), device="cpu")
    p = teng.params
    z = np.random.default_rng(3).uniform(-1, 1, p.slot_count) + \
        1j * np.random.default_rng(4).uniform(-1, 1, p.slot_count)
    lvl = 4
    t_pt = teng.encode(z, level=lvl, device=True)
    j_pt = jeng.encode(z, level=lvl, device=True)
    tol = 1e-5                    # ~1e-6 relative c64 error of the scale
    sk = interop.to_tensor(np.asarray(tiny_engine["sk"].s_eval), device="cpu")
    for data in (t_pt.data,
                 interop.to_tensor(np.asarray(j_pt.data), device="cpu")):
        # exact decode of the plaintext: a trivial ciphertext under any key
        res = tengine._decrypt_core(
            p, teng.tabs, torch.stack([data, torch.zeros_like(data)]), sk)
        vals = rns.crt_to_centered_float(
            interop.to_numpy(res).astype(np.uint64), p.active_primes(lvl))
        slots = encoding.coeffs_to_slots(vals, p, p.scale)
        assert np.max(np.abs(slots - z)) < tol
    # decode: the same residues through both device decoders
    trivial = torch.stack([t_pt.data, torch.zeros_like(t_pt.data)])
    res = tengine._decrypt_core(p, teng.tabs, trivial, sk)
    t_dec = tdev._decode_slots_dev(p, res[:2], p.scale).numpy()
    j_dec = np.asarray(jdev._decode_slots_dev(
        jeng.params, interop.to_numpy(res[:2]), p.scale))
    assert np.max(np.abs(t_dec - j_dec)) < tol
    assert np.max(np.abs(t_dec[0] + 1j * t_dec[1] - z)) < 2 * tol


def test_engine_device_rule():
    """Entry points run on the card unless the caller asks for the CPU."""
    p = get_params("tiny")
    residues = np.zeros((2, 4), dtype=np.uint32)
    if torch.cuda.is_available():
        assert Engine(p).device.type == "cuda"
        assert interop.to_tensor(residues).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Engine(p)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            interop.ciphertext(residues, p.scale)
    assert Engine(p, device="cpu").device.type == "cpu"
    assert interop.to_tensor(residues, device="cpu").device.type == "cpu"


# --------------------------------------------------------------------------
# production keygen: OSEntropyRNG, rng= and AESFHE_KEYGEN_RNG=os

def _draws(rng, n=64):
    """One call of every sampling method keygen and encryption make."""
    return [rng.choice(n, 8, replace=False), rng.choice(np.array([-1, 1]), 8),
            rng.random(n), rng.normal(0.0, 3.2, n),
            rng.integers(0, 97, (3, n), dtype=np.uint32)]


def test_os_entropy_rng_has_the_references_methods():
    """The reference's four sampling methods, each draw of the seeded
    draw's dtype and shape, and fresh entropy on every call."""
    def methods(cls):
        return {m for m in vars(cls) if not m.startswith("_")}

    assert methods(tkeys.OSEntropyRNG) == methods(jkeys._OSEntropyRNG) == \
        {"choice", "random", "normal", "integers"}
    rng = tkeys.OSEntropyRNG()
    got, again = _draws(rng), _draws(rng)
    for g, w in zip(got, _draws(np.random.default_rng(0)), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
    assert not np.array_equal(got[2], again[2])
    assert not np.array_equal(got[4], again[4])


def test_os_entropy_engines_draw_different_secret_keys():
    """Two engines on OSEntropyRNG: different ternary secret keys, each of
    the profile's Hamming weight (boot_tiny: h = 16)."""
    p = get_params("boot_tiny")
    sks = [Engine(p, device="cpu", rng=tkeys.OSEntropyRNG())
           .create_secret_key().s_coeff for _ in range(2)]
    for s in sks:
        assert int(np.count_nonzero(s)) == p.secret_hamming == 16
        assert set(np.unique(s)) <= {-1, 0, 1}
    assert not np.array_equal(sks[0], sks[1])


def test_keygen_rng_env_selects_os_entropy(monkeypatch):
    """AESFHE_KEYGEN_RNG=os makes Engine(rng=None) draw from OSEntropyRNG;
    without it the engine keeps a numpy Generator; an explicit rng wins."""
    p = get_params("tiny")
    monkeypatch.setenv("AESFHE_KEYGEN_RNG", "os")
    assert isinstance(Engine(p, device="cpu").rng, tkeys.OSEntropyRNG)
    seeded = np.random.default_rng(0)
    assert Engine(p, device="cpu", rng=seeded).rng is seeded
    monkeypatch.delenv("AESFHE_KEYGEN_RNG")
    assert isinstance(Engine(p, device="cpu").rng, np.random.Generator)


def test_os_entropy_key_family_encrypts_and_decrypts():
    """A tiny-profile key family on OSEntropyRNG through the wrapper:
    encrypt, a relinearized product and a rotation decrypt right."""
    from aesfhe_tpu_torch.ops.xor_service import EngineWrapper, XORConfig
    w = EngineWrapper(XORConfig(profile="tiny", rotation_steps=(1,),
                                device="cpu"), rng=tkeys.OSEntropyRNG())
    assert isinstance(w.engine.rng, tkeys.OSEntropyRNG)
    x = np.random.default_rng(5).uniform(-1, 1, w.engine.slot_count)
    ct = w.encrypt(x)
    assert np.max(np.abs(np.real(w.decrypt(ct)) - x)) < 1e-3
    assert np.max(np.abs(np.real(w.decrypt(w.multiply(ct, ct))) - x * x)) \
        < 1e-3
    assert np.max(np.abs(np.real(w.decrypt(w.rotate(ct, 1)))
                         - np.roll(x, 1))) < 1e-3
