"""Trace the bit-sliced round's noise and scale stage by stage.

    python -m aesfhe_tpu_torch.noise_trace [--profile prod_boot]
                                           [--device cuda] 54 43 29 15
    python -m aesfhe_tpu_torch.noise_trace --inverse [--profile prod_boot]

For each start level: encrypt random blocks, drop them to that level, run
rounds (AddRoundKey, SubBytes, ShiftRows, MixColumns, cleanse) while at
least one round's depth is left, and after every stage print the level,
the tracked scale over Delta, and over all 8 planes the smallest |slot| and
the largest | |slot| - 1 | (every slot should be +-1).  First prints how
far the profile's rescale primes stray from Delta, by level band.
Runs on the card; without one it raises unless given `--device cpu`.

`--inverse` traces the inverse cipher instead: the key family and the
fused bootstrap of `run_full_aes.setup`, AES ciphertexts of random blocks
(block 0 FIPS-197 C.1's) at the work level, then
`run_full_aes.run_inverse_round` itself, with its services wrapped to print
each stage (the refresh and its cleanse, ARK, InvSubBytes, InvShiftRows,
InvMixColumns with its folded AddRoundKey, the cleanse), each line with the
bytes that differ from the same stage computed in the clear.
"""
from __future__ import annotations

import argparse

import numpy as np

from . import run_full_aes
from .aes_tables import aes128_partial
from .core import dev_encoding
from .core import engine as engine_mod
from .keyexp import inv_mix_columns
from .ops.bitplane import AES_INV_SBOX, BitState
from .ops.xor_service import EngineWrapper, XORConfig
from .pipeline import AESFHE128Bitsliced

KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="prod_boot")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--inverse", action="store_true",
                    help="trace the inverse cipher with its refreshes")
    ap.add_argument("starts", type=int, nargs="*")
    args = ap.parse_args(argv)
    if args.inverse:
        aes, keygen_s = run_full_aes.setup(args.profile, args.seed,
                                           args.device)
        print(f"keygen {keygen_s:.1f} s", flush=True)
        return trace_inverse(aes, args.seed)
    wrap = EngineWrapper(XORConfig(profile=args.profile, rotation_steps=(),
                                   device=engine_mod.resolve_device(
                                       args.device)),
                         rng=np.random.default_rng(args.seed))
    aes = AESFHE128Bitsliced(wrap, KEY)
    eng, svc = wrap.engine, aes.svc
    p = eng.params
    dev = np.abs(np.asarray(p.q_primes[1:], dtype=np.float64) / p.scale - 1)
    for lo, hi in ((1, 15), (16, 29), (30, 42), (43, p.top_level)):
        hi = min(hi, p.top_level)
        if lo > hi:                      # a shorter chain than prod_boot's
            break
        print(f"levels {lo}-{hi}: max |q/Delta - 1| = "
              f"{dev[lo - 1:hi].max():.4f}")

    def stat(tag, st):
        smallest, worst = np.inf, 0.0
        for ct in st.bits:
            res = engine_mod._decrypt_core(p, eng.tabs, ct.data,
                                           wrap.secret_key.s_eval)
            v = dev_encoding._decode_slots_dev(p, res[:2], float(ct.scale))
            v = v[0].double().cpu().numpy()
            smallest = min(smallest, float(np.abs(v).min()))
            worst = max(worst, float(np.abs(np.abs(v) - 1).max()))
        print(f"  {tag:8s} level {st.level:2d}  scale/Delta "
              f"{st.bits[0].scale / p.scale:.4g}  min|v| {smallest:.3e}  "
              f"max||v|-1| {worst:.3e}", flush=True)

    state = np.random.default_rng(args.seed + 1).integers(
        0, 256, p.slot_count, dtype=np.uint8)
    for start in args.starts:
        print(f"start level {start}", flush=True)
        st = aes.encrypt_state(state)
        st = BitState([eng._drop(b, start) for b in st.bits])
        stat("fresh", st)
        r = 1
        while st.level >= AESFHE128Bitsliced.ROUND_DEPTH + 1:
            st = svc.xor_plain(st, aes.round_keys[r - 1])
            stat("ark", st)
            st = svc.sub_bytes(st)
            stat("sub", st)
            st = svc.shift_rows(st)
            stat("shift", st)
            st = svc.mix_columns(st)
            stat("mix", st)
            st = svc.cleanse(st)
            stat("cleanse", st)
            r += 1


# InvShiftRows on [blocks, 16] bytes (byte i: row i % 4, column i // 4)
_IDX = np.arange(16)
_INV_SHIFT = np.argsort((_IDX % 4) + 4 * (((_IDX // 4) + (_IDX % 4)) % 4))


def _fold(x, fold_key=None):
    return x if fold_key is None else x ^ fold_key


# each traced stage's effect on the clear [blocks, 16] state, called with
# the stage's own arguments
_CLEAR = {
    "xor_plain": lambda x, key: x ^ key,
    "sub_bytes": lambda x, inverse: AES_INV_SBOX[x],
    "shift_rows": lambda x, inverse, fold_key=None: _fold(x[:, _INV_SHIFT],
                                                          fold_key),
    "mix_columns": lambda x, inverse, fold_key=None, align=True: _fold(
        np.stack([inv_mix_columns(b) for b in x]), fold_key),
    "cleanse": lambda x: x,
    "_refresh": lambda x, need_levels: x,
}


def trace_inverse(aes: AESFHE128Bitsliced, seed: int):
    """The inverse cipher (key KEY) of random blocks through
    run_inverse_round, every stage printed; the wrappers are taken off
    the instances afterwards."""
    wrap = aes.eng
    eng, svc = wrap.engine, aes.svc
    p = eng.params
    pt = run_full_aes.make_state(p.slot_count, seed + 1).reshape(-1, 16)
    clear = np.stack([aes128_partial(b, KEY, 10) for b in pt])
    print(f"inverse cipher of {len(pt)} blocks, "
          f"block 0 {bytes(clear[0]).hex()}", flush=True)

    def stat(tag, st):
        worst = 0.0
        for ct in st.bits:
            res = engine_mod._decrypt_core(p, eng.tabs, ct.data,
                                           wrap.secret_key.s_eval)
            v = dev_encoding._decode_slots_dev(p, res[:2], float(ct.scale))
            v = v[0].double().cpu().numpy()
            worst = max(worst, float(np.abs(np.abs(v) - 1).max()))
        wrong = int(np.count_nonzero(svc.decrypt_state(st) !=
                                     clear.reshape(-1)))
        print(f"  {tag:11s} levels {min(b.level for b in st.bits):2d}-"
              f"{max(b.level for b in st.bits):2d}  scale/Delta "
              f"{st.bits[0].scale / p.scale:.4g}  max||v|-1| {worst:.3e}  "
              f"wrong bytes {wrong}", flush=True)

    def watch(obj, name):
        """Print each call of obj.name with the clear state it should
        hold (the refresh's own cleanse included)."""
        body = getattr(obj, name)

        def traced(st, *args, **kw):
            nonlocal clear
            out = body(st, *args, **kw)
            if out is not st:
                clear = _CLEAR[name](clear, *args, **kw)
                stat(name.lstrip("_"), out)
            return out
        setattr(obj, name, traced)

    st = aes.encrypt_state(clear.reshape(-1))
    st = BitState([eng._drop(b, aes.ROUND_DEPTH + 1) for b in st.bits])
    stat("input", st)
    boots = eng.counters["bootstrap"]
    owners = {name: aes if name == "_refresh" else svc for name in _CLEAR}
    for name, obj in owners.items():
        watch(obj, name)
    try:
        for i in range(1, 11):
            print(f"inverse round {i}", flush=True)
            st = run_full_aes.run_inverse_round(aes, st, i, 10)
    finally:
        for name, obj in owners.items():
            delattr(obj, name)
    print(f"bootstraps {eng.counters['bootstrap'] - boots}; plaintexts "
          f"{'equal' if np.array_equal(clear, pt) else 'DIFFER'}; block 0 "
          f"{bytes(svc.decrypt_state(st)[:16]).hex()}", flush=True)


if __name__ == "__main__":
    main()
