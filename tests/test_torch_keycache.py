"""The port's on-disk key cache (utils/serialization.py
cached_key_family / cached_bootstrap_key) and `python -m aesfhe_tpu_torch
keygen`: files the port writes load in the reference and the reverse,
under the same names; a hit returns the saved keys without drawing from the
generator; concurrent writers of one entry do not race (the reference's
fixed temp name does, ROADMAP queue 3)."""
import threading

import numpy as np
import pytest
import torch

from aesfhe_tpu.core.engine import Engine as JEngine
from aesfhe_tpu.core.keys import SecretKey as JSecretKey
from aesfhe_tpu.utils import serialization as jser
from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.params import CKKSParams, get_params
from aesfhe_tpu_torch.utils import serialization as tser

FAMILY = ("relin", "conj")


def _same_key(tkey, jkey):
    assert np.array_equal(interop.to_numpy(tkey.b), np.asarray(jkey.b))
    assert np.array_equal(interop.to_numpy(tkey.a), np.asarray(jkey.a))


def _same_family(t, j):
    assert np.array_equal(interop.to_numpy(t["secret"].s_eval),
                          np.asarray(j["secret"].s_eval))
    assert np.array_equal(t["secret"].s_coeff, np.asarray(
        j["secret"].s_coeff))
    for name in FAMILY:
        _same_key(t[name], j[name])
    assert np.array_equal(interop.to_numpy(t["public"].b),
                          np.asarray(j["public"].b))
    assert sorted(t["rotation"].keys) == sorted(j["rotation"].keys)
    for g, k in t["rotation"].keys.items():
        _same_key(k, j["rotation"].keys[g])


@pytest.mark.parametrize("steps", [None, (1, 3)])
def test_key_family_files_cross_both_ways(tmp_path, steps):
    """The port writes and the reference reads (a hit on its side: no
    keygen), both for the power-of-two ladder (None) and for explicit
    steps; for explicit steps also the reverse (the reference's keygen of
    the ladder costs ~5 s of JAX compiles on the CPU, so the ladder's
    reverse direction is left to the steps case's file format)."""
    p = get_params("tiny")
    teng = Engine(p, device="cpu", rng=np.random.default_rng(5))
    fam = tser.cached_key_family(teng, tmp_path / "a", rotation_steps=steps)
    files = sorted(x.name for x in (tmp_path / "a").iterdir())
    assert len(files) == 1
    if steps is None:
        assert files == [f"keys_{jser.params_fingerprint(p)}.npz"]
    jfam = jser.cached_key_family(JEngine(p), tmp_path / "a",
                                  rotation_steps=steps)
    _same_family(fam, jfam)
    # a second port call is a hit: same keys, no draw from the generator
    state = teng.rng.bit_generator.state
    again = tser.cached_key_family(teng, tmp_path / "a",
                                   rotation_steps=steps)
    assert teng.rng.bit_generator.state == state
    _same_family(again, jfam)
    if steps is None:
        return
    # the reference writes, the port reads
    jfam2 = jser.cached_key_family(JEngine(p), tmp_path / "b",
                                   rotation_steps=steps)
    fam2 = tser.cached_key_family(Engine(p, device="cpu"), tmp_path / "b",
                                  rotation_steps=steps)
    _same_family(fam2, jfam2)
    assert sorted(x.name for x in (tmp_path / "b").iterdir()) == files


def test_bootstrap_galois_file_crosses_to_the_reference(tmp_path):
    """The port's bootrot_<hash>.npz is the file the reference's
    cached_bootstrap_key looks for: it loads the port's Galois keys from
    it instead of generating its own."""
    params = CKKSParams(n=1 << 8, max_level=28, scale_bits=27,
                        first_prime_bits=30, num_special_primes=4,
                        secret_hamming=8)
    teng = Engine(params, device="cpu", rng=np.random.default_rng(2))
    sk = teng.create_secret_key()
    bk = tser.cached_bootstrap_key(teng, sk, tmp_path)
    assert len(list(tmp_path.iterdir())) == 1
    state = teng.rng.bit_generator.state
    bk2 = tser.cached_bootstrap_key(teng, sk, tmp_path)
    assert teng.rng.bit_generator.state == state
    jsk = JSecretKey(interop.to_numpy(sk.s_eval), sk.s_coeff)
    jbk = jser.cached_bootstrap_key(JEngine(params), jsk, tmp_path)
    assert sorted(jbk.rot.keys) == sorted(bk.rot.keys) == sorted(bk2.rot.keys)
    for g, k in bk.rot.keys.items():
        _same_key(k, jbk.rot.keys[g])
        assert torch.equal(k.b, bk2.rot.keys[g].b)


def test_concurrent_writers_do_not_race(tmp_path):
    """Eight threads replace one cache entry five times each: every write
    goes through its own temp name, so none fails (the reference's shared
    `keys_<hash>.tmp.npz` makes one writer's os.replace find the other's
    file gone), no temp file is left, and the entry loads."""
    p = get_params("tiny")
    eng = Engine(p, device="cpu", rng=np.random.default_rng(1))
    sk = eng.create_secret_key()
    relin = eng.create_relinearization_key(sk)
    path = tmp_path / "keys_x.npz"
    errors = []

    def writer():
        try:
            for _ in range(5):
                tser._save_atomic(path, secret=sk, relin=relin)
        except Exception as e:          # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert [x.name for x in tmp_path.iterdir()] == ["keys_x.npz"]
    got = tser.load_keys(path, device="cpu")
    assert torch.equal(got["relin"].b, relin.b)


def test_cli_keygen_file_loads_in_the_reference(tmp_path, capsys):
    from aesfhe_tpu_torch.__main__ import main
    out = tmp_path / "fam.npz"
    main(["keygen", str(out), "--profile", "tiny", "--seed", "4",
          "--device", "cpu"])
    assert "keygen+serialize (tiny, seed 4" in capsys.readouterr().out
    j = jser.load_keys(out)
    t = tser.load_keys(out, device="cpu")
    _same_family(t, j)
    assert len(t["rotation"].keys) > 0


def test_engine_context_key_cache(tmp_path):
    """EngineContext(key_cache=dir): the first context generates and saves
    the family and the bootstrap's Galois keys, a second one (a restarted
    process) loads the same keys."""
    from aesfhe_tpu_torch.context import EngineContext
    params = CKKSParams(n=1 << 8, max_level=28, scale_bits=27,
                        first_prime_bits=30, num_special_primes=4,
                        secret_hamming=8)
    kw = dict(params=params, device="cpu", rotation_steps=(1,),
              use_bootstrap=True, key_cache=tmp_path)
    a = EngineContext(rng=np.random.default_rng(0), **kw)
    assert len(list(tmp_path.iterdir())) == 2        # keys_*, bootrot_*
    b = EngineContext(rng=np.random.default_rng(1), **kw)
    assert torch.equal(a.secret_key.s_eval, b.secret_key.s_eval)
    assert torch.equal(a.relinearization_key.b, b.relinearization_key.b)
    assert sorted(a.rotation_key.keys) == sorted(b.rotation_key.keys)
    for g, k in a.bootstrap_key.rot.keys.items():
        assert torch.equal(k.a, b.bootstrap_key.rot.keys[g].a)
