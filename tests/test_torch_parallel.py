"""The port's multi-device path (aesfhe_tpu_torch.parallel) on the CPU:
D = 2 and D = 4 ranks, each a spawned process in a gloo process group
(tests/torch_mesh_ranks.py holds the rank functions), held with
torch.equal to the port's single-device Engine inside each rank and to the
reference's MeshEngine / DistKeySwitch / DistNTT on the conftest's virtual
8-device CPU mesh here, on the reference's tiny keys and ciphertexts
carried across by interop.py.

Also: the collective ledger's counts and bytes against the reference's
ledger of the same programs, the batched square of
tests/test_parallel.py::test_batched_sharded_square on a (data 2, limb 2)
mesh, key sharding and padding, and (slow) a whole bootstrap through the
MeshEngine at D = 2 against the single-device one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from aesfhe_tpu.ops.zeta import ZetaEncoder
from aesfhe_tpu.parallel.comm_ledger import collective_stats
from aesfhe_tpu.parallel.dist_keyswitch import DistKeySwitch
from aesfhe_tpu.parallel.dist_ntt import DistNTT
from aesfhe_tpu.parallel.mesh_engine import MeshEngine as JMeshEngine
from aesfhe_tpu_torch.parallel import launch
from tests import torch_mesh_ranks as ranks


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Several test workers share the cores, and torch's default pool of one
    thread per core then stalls in its barriers; two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


STEPS = [1, 2, 4]
REF_D = 4                      # the reference's mesh, as tests/test_parallel.py


def _keys(E):
    return dict(
        s_eval=np.asarray(E["sk"].s_eval), s_coeff=np.asarray(E["sk"].s_coeff),
        rlk=(np.asarray(E["rlk"].b), np.asarray(E["rlk"].a), None),
        conj=(np.asarray(E["conj"].b), np.asarray(E["conj"].a), None),
        rot={int(g): (np.asarray(k.b), np.asarray(k.a),
                      getattr(k, "cap", None))
             for g, k in E["rot"].keys.items()})


@pytest.fixture(scope="module")
def ref(tiny_engine):
    """The reference's results on its virtual mesh: MeshEngine ops at two
    levels, one DistKeySwitch and one hoisted application, DistNTT fwd, and
    the ledgers of those programs; plus the inputs for the port."""
    E = tiny_engine
    eng = E["eng"]
    p = eng.params
    mesh = Mesh(np.asarray(jax.devices()[:REF_D]), ("limb",))
    meng = JMeshEngine(p, mesh=mesh)
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 16, eng.slot_count, dtype=np.uint8)
    ct = eng.encrypt(ZetaEncoder.to_zeta(vals, 16), E["pk"])
    # the port's ranks run every op at both levels against the port's
    # single-device Engine; the reference's MeshEngine programs run here at
    # the top level only (each costs ~1-3 s of JAX compiles on the CPU)
    levels = (p.top_level, 4)
    lvl = p.top_level
    out = {f"mul@{lvl}/0": meng.multiply(ct, ct, E["rlk"]),
           f"rot@{lvl}/0": meng.rotate(ct, E["rot"], 3),
           f"conj@{lvl}/0": meng.conjugate(ct, E["conj"])}
    for i, h in enumerate(meng.hoisted_rotations(ct, E["rot"], STEPS)):
        out[f"hoist@{lvl}/{i}"] = h
    # (the MeshEngine's multiply, rotate and hoisted batch are its
    # DistKeySwitch's relin, galois and decompose + hoisted_apply; the
    # ranks hold those pieces to the port's single-device ops one by one)
    out = {k: np.asarray(v.data) for k, v in out.items()}
    dks = DistKeySwitch(p, eng.tabs, mesh)
    rb, ra = dks.key_shards(E["rlk"])
    prog = dks._prog(lvl)
    ks_led = collective_stats(prog["keyswitch"],
                              jnp.zeros((lvl + 1, p.n), jnp.uint32), rb, ra)
    dn = DistNTT(p, mesh)
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(0, int(q), p.n)
                  for q in p.q_primes[:p.num_q]]).astype(np.uint32)
    fwd = np.asarray(dn.unpack_eval(dn.fwd(dn.pack(jnp.asarray(x)))))
    ntt_led = collective_stats(dn.fwd, dn.pack(jnp.asarray(x)))
    return dict(E=E, ct=ct, levels=levels, out=out, ks_led=ks_led,
                ntt_led=ntt_led, ntt_x=x, ntt_fwd=fwd, ref_pad=dks.pad)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_equals_single_and_reference(ref, world):
    """D ranks: MeshEngine multiply/rotate/conjugate/hoisted rotations at
    two levels, DistKeySwitch keyswitch/relin/galois/decompose +
    hoisted_apply, DistNTT fwd/inv: torch.equal to the port's single-device
    Engine in every rank (tests/torch_mesh_ranks.py) and to the reference's
    MeshEngine here.  Every key-switch goes through the collective hooks
    (one all-reduce of 2*M*N*8 bytes each), and the ledger's bytes equal
    the reference ledger's for the same program.  D = 4 adds the batched
    square over a (data 2, limb 2) mesh."""
    E = ref["E"]
    p = E["eng"].params
    stack = scale = None
    if world == 4:
        rng = np.random.default_rng(0)
        vals = rng.integers(0, 16, (4, p.slot_count), dtype=np.uint8)
        cts = [E["eng"].encrypt(ZetaEncoder.to_zeta(v, 16), E["pk"])
               for v in vals]
        stack = np.stack([np.asarray(c.data) for c in cts])
    ct = ref["ct"]
    res = launch.spawn(ranks.all_cases, world, "tiny", _keys(E),
                       np.asarray(ct.data), ct.scale, ref["levels"], STEPS,
                       3, stack, timeout_s=300)
    eng0 = res[0]["engine"]
    # every rank holds the same replicated results
    for r in res[1:]:
        for k, v in r["engine"]["out"].items():
            assert np.array_equal(v, eng0["out"][k]), (r, k)
    for k, want in ref["out"].items():
        assert np.array_equal(eng0["out"][k], want), k
    # each op's key-switches all went through DistKeySwitch: one
    # all-reduce of 2*M*N*8 bytes per switch (rotate by 3 = two switches
    # on the power-of-two ladder; a hoisted batch of 3 = three)
    per = {"mul": 1, "rot": 2, "conj": 1, "hoist": len(STEPS)}
    for lvl in ref["levels"]:
        M = lvl + 1 + p.num_special
        for name, k in per.items():
            assert eng0["counts"][f"{name}@{lvl}"] == (k, k, k * 2 * M * p.n * 8)
    assert eng0["pad"] == -(-p.dnum // world) * world
    assert [r["engine"]["digits"] for r in res] == [
        (i * eng0["pad"] // world, (i + 1) * eng0["pad"] // world)
        for i in range(world)]
    # the reference's key-switch ledger: 2 psums (two 16-bit halves of
    # uint32) of 2*M*N*4 bytes each; the port: one int64 all-reduce with
    # the same bytes
    M = p.top_level + 1 + p.num_special
    assert ref["ks_led"].counts == {"psum": 2}
    assert ref["ks_led"].bytes_in["psum"] == 2 * M * p.n * 8
    nt = res[0]["ntt"]
    assert np.array_equal(nt["fwd"], ref["ntt_fwd"])
    assert nt["fwd_counts"] == nt["inv_counts"] == {"all_to_all": 1}
    assert ref["ntt_led"].counts == {"all_to_all": 1}
    # per-rank operand bytes: the reference's shard is [L, A, A/4] uint32
    assert nt["fwd_bytes"]["all_to_all"] * world == \
        ref["ntt_led"].bytes_in["all_to_all"] * REF_D
    if world == 4:
        b = res[0]["batch"]
        # two squares per data group; all-gathers: the relin key's
        # fingerprint at its first use, then the batch
        assert b["counts"] == {"psum": 2, "all_gather": 2}
        for r in res[1:]:
            assert np.array_equal(r["batch"]["out"], b["out"])
        for i in range(len(stack)):
            a = E["eng"].multiply(cts[i], cts[i], E["rlk"])
            assert np.array_equal(b["out"][i], np.asarray(a.data))
            assert b["scale"] == a.scale
            dec = E["eng"].decrypt(type(a)(b["out"][i], b["scale"]), E["sk"])
            want = ZetaEncoder.to_zeta(vals[i], 16) ** 2
            assert np.max(np.abs(dec - want)) < 5e-3


@pytest.mark.slow
def test_pieces_and_lower_level_equal_reference(ref):
    """The reference's DistKeySwitch pieces on its virtual mesh (keyswitch,
    decompose + hoisted_apply) and its MeshEngine at level 4 against the
    port's at D = 2 (`slow`: ~10 s of the reference's JAX compiles)."""
    E = ref["E"]
    eng = E["eng"]
    p = eng.params
    ct = ref["ct"]
    mesh = Mesh(np.asarray(jax.devices()[:REF_D]), ("limb",))
    dks = DistKeySwitch(p, eng.tabs, mesh)
    want = {}
    kb, ka = dks.keyswitch(ct.data[1], E["rlk"])
    want["ks_b"], want["ks_a"] = np.asarray(kb), np.asarray(ka)
    g = p.rot_galois_elt(STEPS[0])
    want["hoisted_apply"] = np.asarray(dks.hoisted_apply(
        ct.data, dks.decompose(ct.data[1]), jnp.asarray(p.galois_perm(g)),
        E["rot"].keys[g]))
    meng = JMeshEngine(p, mesh=mesh)
    a = eng._drop(ct, 4)
    want["mul@4/0"] = np.asarray(meng.multiply(a, a, E["rlk"]).data)
    want["rot@4/0"] = np.asarray(meng.rotate(a, E["rot"], 3).data)
    want["conj@4/0"] = np.asarray(meng.conjugate(a, E["conj"]).data)
    for i, h in enumerate(meng.hoisted_rotations(a, E["rot"], STEPS)):
        want[f"hoist@4/{i}"] = np.asarray(h.data)
    res = launch.spawn(ranks.engine_case, 2, "tiny", _keys(E),
                       np.asarray(ct.data), ct.scale, ref["levels"], STEPS,
                       timeout_s=300)
    for k, w in want.items():
        assert np.array_equal(res[0]["out"][k], w), k


def test_dryrun_multichip_four_ranks():
    """graft_entry.dryrun_multichip(4): the batched ARK + SubBytes step on a
    (data 2, limb 2) mesh equals the single-device step lane by lane, lane
    0 decodes to the S-box, and the distributed NTT is exact."""
    from aesfhe_tpu_torch.graft_entry import dryrun_multichip
    out = dryrun_multichip(4, device="cpu")
    assert out["mesh"] == (2, 2) and out["batch"] == 4
    assert out["ntt_exact"] is True and out["keyswitches"] > 0


def test_graft_entry_step():
    """graft_entry.entry(): SubBytes on a nibble pair at N = 2^10, a
    callable and its example ciphertexts; the step's outputs are two
    ciphertexts of the same shape, below the inputs' level."""
    from aesfhe_tpu_torch.graft_entry import entry
    fn, (hi, lo) = entry(device="cpu")
    out_hi, out_lo = fn(hi, lo)
    assert out_hi.shape == out_lo.shape
    assert out_hi.shape[0] == 2 and out_hi.shape[2] == hi.shape[2]
    assert out_hi.shape[1] < hi.shape[1]


def test_fused_bootstrap_refused_on_a_mesh():
    """A CUDA graph cannot capture the mesh's collectives: XORConfig with a
    mesh and fused_boot=True raises instead of falling back."""
    from aesfhe_tpu_torch.ops.xor_service import XORConfig
    with pytest.raises(ValueError, match="cannot capture"):
        XORConfig(profile="tiny", device="cpu", fused_boot=True,
                  mesh=object())


@pytest.mark.slow
def test_mesh_engine_bootstrap_equals_single_device():
    """A whole bootstrap (ModRaise, CoeffToSlot, EvalMod, SlotToCoeff) with
    every key-switch digit-sharded over 2 ranks equals the single-device
    bootstrap bit for bit and decodes exactly."""
    res = launch.spawn(ranks.boot_case, 2, 6, timeout_s=1200)
    assert res[0] == res[1] > 0
