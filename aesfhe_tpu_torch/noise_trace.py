"""Trace the bit-sliced round's noise and scale stage by stage.

    python -m aesfhe_tpu_torch.noise_trace [--profile prod_boot] 54 43 29 15

For each start level: encrypt random blocks, drop them to that level, run
rounds (AddRoundKey, SubBytes, ShiftRows, MixColumns, cleanse) while at
least one round's depth is left, and after every stage print the level,
the tracked scale over Delta, and over all 8 planes the smallest |slot| and
the largest | |slot| - 1 | (every slot should be +-1).  First prints how
far the profile's rescale primes stray from Delta, by level band.
Runs on the card when there is one, else on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .core import dev_encoding
from .core import engine as engine_mod
from .ops.bitplane import BitState
from .ops.xor_service import EngineWrapper, XORConfig
from .pipeline import AESFHE128Bitsliced

KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="prod_boot")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("starts", type=int, nargs="+")
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    wrap = EngineWrapper(XORConfig(profile=args.profile, rotation_steps=(),
                                   device=device),
                         rng=np.random.default_rng(args.seed))
    aes = AESFHE128Bitsliced(wrap, KEY)
    eng, svc = wrap.engine, aes.svc
    p = eng.params
    dev = np.abs(np.asarray(p.q_primes[1:], dtype=np.float64) / p.scale - 1)
    for lo, hi in ((1, 15), (16, 29), (30, 42), (43, p.top_level)):
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


if __name__ == "__main__":
    main()
