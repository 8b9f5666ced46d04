"""Rank functions of the port's mesh tests: each runs in a spawned process
(`aesfhe_tpu_torch.parallel.launch.spawn`), so this module imports no JAX
and nothing of the reference package.  Inputs arrive as numpy arrays (the
reference's keys and ciphertexts, or seeds); each function checks what one
rank can check and returns numpy arrays for the test to hold against the
reference's results.
"""
import numpy as np
import torch

from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.core import ks_inner, ntt, ops_impl
from aesfhe_tpu_torch.core.ciphertext import Ciphertext
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.params import get_params
from aesfhe_tpu_torch.parallel import comm_ledger
from aesfhe_tpu_torch.parallel.batch import sharded_circuit
from aesfhe_tpu_torch.parallel.dist_ntt import DistNTT
from aesfhe_tpu_torch.parallel.mesh import make_mesh
from aesfhe_tpu_torch.parallel.mesh_engine import MeshEngine
from aesfhe_tpu_torch.parallel.multihost import fetch_global, sharded_global


def _keys(k):
    """The reference's key arrays -> port keys on the CPU."""
    return dict(
        sk=interop.secret_key(k["s_eval"], k["s_coeff"], device="cpu"),
        rlk=interop.switch_key(*k["rlk"], device="cpu"),
        conj=interop.switch_key(*k["conj"], device="cpu"),
        rot=interop.galois_keys(k["rot"], device="cpu"))


def _np(t):
    return interop.to_numpy(t)


def engine_case(rank, world, profile, keys, ct_arr, scale, levels, steps):
    """MeshEngine over a (1, world) mesh against the single-device Engine
    on the same keys and ciphertext: multiply (+relin), rotate, conjugate
    and a hoisted batch at each level, every output torch.equal; the
    key-switches each hook issued, the kernel's launches and the ledger.
    Returns rank 0's outputs {name: uint32 array}."""
    torch.set_num_threads(1)
    p = get_params(profile)
    mesh = make_mesh(1, world)
    eng = Engine(p, device="cpu")
    meng = MeshEngine(p, mesh=mesh, device="cpu")
    K = _keys(keys)
    ct = interop.ciphertext(ct_arr, scale, device="cpu")
    out, counts = {}, {}
    for lvl in levels:
        a = eng._drop(ct, lvl)
        cases = {
            "mul": lambda e: [e.multiply(a, a, K["rlk"])],
            "rot": lambda e: [e.rotate(a, K["rot"], 3)],
            "conj": lambda e: [e.conjugate(a, K["conj"])],
            "hoist": lambda e: e.hoisted_rotations(a, K["rot"], steps),
        }
        for name, run in cases.items():
            want = run(eng)
            s0, l0 = sum(meng.dks.levels.values()), ks_inner.launches
            with comm_ledger.recording() as st:
                got = run(meng)
            switches = sum(meng.dks.levels.values()) - s0
            for g, w in zip(got, want):
                assert torch.equal(g.data, w.data), (name, lvl)
                assert g.scale == w.scale
            counts[f"{name}@{lvl}"] = (switches, st.counts.get("psum", 0),
                                       st.bytes_in.get("psum", 0))
            for i, g in enumerate(got):
                out[f"{name}@{lvl}/{i}"] = _np(g.data)
    # the distributed key-switch pieces on their own
    dks = meng.dks
    c1 = ct.data[1]
    with comm_ledger.recording() as st:
        b, a = dks.keyswitch(c1, K["rlk"])
    wb, wa = ops_impl.keyswitch(p, eng.tabs, c1, K["rlk"].b, K["rlk"].a)
    assert torch.equal(b, wb) and torch.equal(a, wa)
    out["ks_b"], out["ks_a"] = _np(b), _np(a)
    M = p.top_level + 1 + p.num_special
    assert st.counts == {"psum": 1}, st.counts
    assert st.bytes_in["psum"] == 2 * M * p.n * 8
    d3 = eng.multiply(ct, ct).data                      # degree 2, no relin
    assert torch.equal(dks.relin(d3, K["rlk"]), eng._relin_data(d3, K["rlk"]))
    g = p.rot_galois_elt(steps[0])
    perm = eng._perm_dev(g)
    assert torch.equal(dks.galois(ct.data, perm, K["rot"].keys[g]),
                       eng._galois_data(ct.data, g, K["rot"].keys[g]))
    d_loc = dks.decompose(c1)
    j0, j1 = dks.digits
    assert d_loc.shape[0] == dks.pad // world
    full = ops_impl.ks_decompose(p, eng.tabs, c1)
    live = max(0, min(full.shape[0], j1) - j0)
    assert torch.equal(d_loc[:live], full[j0:j0 + live])
    assert not d_loc[live:].any()
    h = dks.hoisted_apply(ct.data, d_loc, perm, K["rot"].keys[g])
    assert torch.equal(h, eng._hoist_apply(ct.data, full, g,
                                           K["rot"].keys[g]))
    st = comm_ledger.collective_stats(dks.hoisted_apply, ct.data, d_loc,
                                      perm, K["rot"].keys[g])
    assert st.counts == {"psum": 1}
    assert st.bytes_in["psum"] == 2 * M * p.n * 8
    out["hoisted_apply"] = _np(h)
    return dict(out=out, counts=counts, digits=dks.digits, pad=dks.pad,
                mode=dks.comm.mode)


def ntt_case(rank, world, profile, seed):
    """DistNTT fwd and inv over a (1, world) mesh against the port's NTT;
    returns the gathered forward output (uint32 [L, N]) and the ledger."""
    torch.set_num_threads(1)
    p = get_params(profile)
    mesh = make_mesh(1, world)
    d = DistNTT(p, mesh)
    L = p.num_q
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, int(q), p.n) for q in p.q_primes[:L]])
    t = p.tables
    rows = ntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, "cpu").rows(range(L))
    want = ntt.ntt_fwd(torch.as_tensor(x), rows)
    xs = sharded_global(mesh, d.pack(x.astype(np.int32)), 2)
    with comm_ledger.recording() as st_f:
        y = d.fwd(xs)
    got = d.unpack_eval(fetch_global(y, mesh, 1))
    assert np.array_equal(got, want.numpy()), "DistNTT fwd"
    with comm_ledger.recording() as st_i:
        z = d.inv(y)
    back = fetch_global(z, mesh, 2).reshape(L, p.n)
    assert np.array_equal(back, x), "DistNTT inv(fwd(x))"
    # each rank sends (D-1)/D of its 1/D shard of the int32 [L, N] array
    assert comm_ledger.alltoall_wire_bytes(L * p.n * 4, world) == \
        st_f.bytes_in["all_to_all"] * (world - 1) / world
    yfull = torch.as_tensor(got).reshape(L, d.A, d.A)
    inv_want = ntt.ntt_inv(torch.as_tensor(got, dtype=torch.int64), rows)
    zi = d.inv(sharded_global(mesh, yfull.numpy().astype(np.int32), 1))
    assert np.array_equal(fetch_global(zi, mesh, 2).reshape(L, p.n),
                          inv_want.numpy()), "DistNTT inv"
    return dict(fwd=got.astype(np.uint32), fwd_counts=st_f.counts,
                inv_counts=st_i.counts, fwd_bytes=st_f.bytes_in,
                inv_bytes=st_i.bytes_in)


def batch_case(rank, world, profile, keys, stack, scale, data_axis):
    """The batched square over a (data_axis, world/data_axis) mesh: each
    data group squares its block of the stack through a MeshEngine, the
    blocks are gathered; every rank's result must equal the single-device
    Engine's square of each ciphertext."""
    torch.set_num_threads(1)
    p = get_params(profile)
    mesh = make_mesh(data_axis, world // data_axis)
    eng = Engine(p, device="cpu")
    meng = MeshEngine(p, mesh=mesh, device="cpu")
    K = _keys(keys)
    st = interop.to_tensor(stack, device="cpu")

    def square(ct):
        return meng.multiply(ct, ct, K["rlk"])

    with comm_ledger.recording() as led:
        out, out_scale = sharded_circuit(square, scale, mesh)(st)
    for b in range(st.shape[0]):
        want = eng.multiply(Ciphertext(st[b], scale),
                            Ciphertext(st[b], scale), K["rlk"])
        assert torch.equal(out[b], want.data) and out_scale == want.scale
    return dict(out=_np(out), scale=out_scale, counts=led.counts)


def all_cases(rank, world, profile, keys, ct_arr, scale, levels, steps,
              ntt_seed, stack):
    """engine_case and ntt_case on a (1, world) mesh, and with a `stack`
    batch_case on a (2, world/2) mesh, in one process group."""
    out = dict(engine=engine_case(rank, world, profile, keys, ct_arr, scale,
                                  levels, steps),
               ntt=ntt_case(rank, world, profile, ntt_seed))
    if stack is not None:
        out["batch"] = batch_case(rank, world, profile, keys, stack, scale, 2)
    return out


def boot_case(rank, world, seed):
    """A whole bootstrap through a MeshEngine over a (1, world) mesh on the
    smallest bootstrap-capable ring (tests/test_parallel.py's), against the
    single-device Engine's bootstrap of the same input with the same keys
    (generated in every rank from `seed`); returns the key-switch count."""
    from aesfhe_tpu_torch.context import EngineContext
    from aesfhe_tpu_torch.core.params import CKKSParams
    from aesfhe_tpu_torch.ops.zeta import ZetaEncoder

    torch.set_num_threads(1)
    params = CKKSParams(n=1 << 8, max_level=28, scale_bits=27,
                        first_prime_bits=30, num_special_primes=4,
                        secret_hamming=8)
    ctx = EngineContext(params=params, device="cpu", rotation_steps=(),
                        use_bootstrap=True, rng=np.random.default_rng(seed))
    mctx = ctx.on_mesh(make_mesh(1, world))
    eng, meng = ctx.engine, mctx.engine
    vals = np.random.default_rng(8).integers(0, 16, params.slot_count)
    low = eng._drop(ctx.encrypt(ZetaEncoder.to_zeta(vals, 16)), 0)
    want = eng.bootstrap(low, ctx.relinearization_key, ctx.conjugation_key,
                         ctx.bootstrap_key)
    got = meng.bootstrap(low, mctx.relinearization_key,
                         mctx.conjugation_key, mctx.bootstrap_key)
    assert torch.equal(got.data, want.data) and got.scale == want.scale
    assert np.array_equal(ZetaEncoder.from_zeta(ctx.decrypt(got), 16), vals)
    assert sum(meng.dks.levels.values()) == meng.counters["keyswitch"] > 0
    return meng.counters["keyswitch"]
