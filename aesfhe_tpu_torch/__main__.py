"""Command-line entry: `python -m aesfhe_tpu_torch <cmd>`.

Commands (each runs on the card unless given --device cpu):
  gen-coeffs                regenerate every LUT coefficient JSON
  keygen OUT [--profile P]  generate a key family from --seed and save it
                            (the reference's .npz format: its load_keys
                            reads the file)
  demo-xor [--profile P]    end-to-end homomorphic 4-bit XOR demo
  demo-aes [--rounds R]     homomorphic AES-128 rounds vs the plain oracle
           [--pipeline zeta|bitsliced] [--bootstrap]
  bench                     the benchmark (one JSON line; AESFHE_BENCH_MODE
                            flagship|bitplane|zeta, see bench.py)
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")


def cmd_gen_coeffs(args):
    from .coeffs import generate
    for name, path in generate.generate_all().items():
        print(name, "->", path)


def cmd_keygen(args):
    from .context import EngineContext
    from .utils.serialization import save_keys
    t0 = time.perf_counter()
    ctx = EngineContext(profile=args.profile, device=args.device,
                        rng=np.random.default_rng(args.seed))
    save_keys(args.out, secret=ctx.secret_key, public=ctx.public_key,
              relin=ctx.relinearization_key, conj=ctx.conjugation_key,
              rotation=ctx.rotation_key)
    print(f"keygen+serialize ({args.profile}, seed {args.seed}, on "
          f"{ctx.engine.device}) -> {args.out} "
          f"[{time.perf_counter() - t0:.1f}s]")


def cmd_demo_xor(args):
    from .ops.xor_service import EngineWrapper, XORConfig, XORService
    eng = EngineWrapper(XORConfig(profile=args.profile, device=args.device),
                        rng=np.random.default_rng(args.seed))
    svc = XORService(eng)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 16, 512, dtype=np.uint8)
    b = rng.integers(0, 16, 512, dtype=np.uint8)
    t0 = time.perf_counter()
    ok = np.array_equal(svc.xor(a, b), a ^ b)
    print(f"homomorphic 4-bit XOR x512 on {eng.engine.device}: correct={ok} "
          f"[{time.perf_counter() - t0:.1f}s]")
    sys.exit(0 if ok else 1)


def cmd_demo_aes(args):
    from .aes_tables import aes128_partial
    from .ops.mixcolumns_service import AESFHETransformer
    from .ops.shiftrows_service import AESFHEShiftRows
    from .ops.xor_service import EngineWrapper, XORConfig, XORService
    from .pipeline import AESFHE128, AESFHE128Bitsliced
    rng = np.random.default_rng(args.seed)
    if args.pipeline == "bitsliced":
        wrap = EngineWrapper(XORConfig(profile=args.profile,
                                       device=args.device,
                                       use_bootstrap=args.bootstrap), rng=rng)
        refresh = wrap.bootstrap if args.bootstrap else None
        aes = AESFHE128Bitsliced(wrap, KEY, refresh=refresh)
    else:
        wrap = EngineWrapper(XORConfig(profile=args.profile,
                                       device=args.device), rng=rng)
        xor_svc = XORService(wrap)
        aes = AESFHE128(wrap, xor_svc, AESFHETransformer(wrap, xor_svc),
                        AESFHEShiftRows(wrap, xor_svc), KEY)
    eng = wrap.engine
    sc = eng.slot_count
    state = np.random.default_rng(0).integers(0, 256, sc, dtype=np.uint8)
    pair = aes.encrypt_state(state)
    t0 = time.perf_counter()
    got = aes.decrypt_state(aes.encrypt_rounds(pair, rounds=args.rounds))
    dt = time.perf_counter() - t0
    want = np.concatenate([aes128_partial(state[b:b + 16], KEY, args.rounds)
                           for b in range(0, sc, 16)])
    ok = np.array_equal(got, want)
    print(f"AES-128 x{args.rounds} round(s), {args.pipeline}, {sc // 16} "
          f"blocks on {eng.device}: correct={ok} [{dt:.1f}s]  "
          f"ops={dict(eng.counters)}")
    sys.exit(0 if ok else 1)


def cmd_bench(args):
    from . import bench
    sys.exit(bench.main(args.device))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="aesfhe_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("gen-coeffs").set_defaults(fn=cmd_gen_coeffs)
    p = sub.add_parser("keygen")
    p.add_argument("out")
    p.add_argument("--profile", default="test")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_keygen)
    p = sub.add_parser("demo-xor")
    p.add_argument("--profile", default="tiny")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_demo_xor)
    p = sub.add_parser("demo-aes")
    p.add_argument("--profile", default="deep")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--pipeline", choices=("zeta", "bitsliced"),
                   default="zeta")
    p.add_argument("--bootstrap", action="store_true",
                   help="refresh between rounds (bitsliced pipeline, "
                        "bootstrap-capable profile)")
    p.set_defaults(fn=cmd_demo_aes)
    p = sub.add_parser("bench")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_bench)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
