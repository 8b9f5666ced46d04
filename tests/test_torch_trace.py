"""The port's spans (`aesfhe_tpu_torch/trace.py`) on the CPU: off, a span
is one shared no-op; under the profiler it is a `ckks.*` range.  The three
ranges of the elementwise ops wrap their functions; one bit-sliced round
nests its stage spans around the primitives' ranges; the refresh span
opens only when the pipeline refreshes; a bootstrap under the profiler
adds its three phase times to the engine's counters, and one without the
profiler adds none.  Imports no JAX."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aesfhe_tpu_torch import bootstrap as tbs
from aesfhe_tpu_torch import trace
from aesfhe_tpu_torch.aes_tables import aes128_partial
from aesfhe_tpu_torch.core import ops_impl
from aesfhe_tpu_torch.core.params import CKKSParams
from aesfhe_tpu_torch.ops.xor_service import EngineWrapper, XORConfig
from aesfhe_tpu_torch.pipeline import AESFHE128Bitsliced

KEY = bytes(range(16))
PHASE_KEYS = [f"boot.{p}_ns" for p in tbs._PhaseTimer.PHASES]
# tests/test_bootstrap.py's boot chain (n=2^9, 34 levels)
BOOT_CHAIN = dict(n=1 << 9, max_level=34, scale_bits=27, first_prime_bits=30,
                  num_special_primes=4, secret_hamming=16)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof) -> list:
    """(name, parent range's name) of every `ckks.*` event."""
    return [(e.name, e.cpu_parent.name if e.cpu_parent else None)
            for e in prof.events() if e.name.startswith("ckks.")]


def test_span_off_is_one_shared_noop():
    assert not trace.on()
    a, b = trace.span("ckks.x"), trace.span("ckks.y")
    assert a is b
    assert not isinstance(a, torch.profiler.record_function)
    with a:
        pass


def test_span_on_is_a_profiler_range():
    with _cpu_profile() as prof:
        assert trace.on()
        s = trace.span("ckks.probe")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(4).sum()
    assert not trace.on()
    assert [n for n, _ in _ranges(prof)] == ["ckks.probe"]


@pytest.fixture(scope="module")
def test_wrap():
    return EngineWrapper(XORConfig(profile="test", rotation_steps=(),
                                   device="cpu"),
                         rng=np.random.default_rng(1))


NEW_SCOPES = [("ct_add", "ckks.add", 2), ("ct_sub", "ckks.add", 2),
              ("ct_negate", "ckks.add", 1),
              ("ct_mul_dense_pt", "ckks.mul_pt", "pt"),
              ("ct_mul_scalar_pt", "ckks.mul_pt", "consts4"),
              ("ct_add_scalar_pt", "ckks.add_scalar", "consts2")]


@pytest.mark.parametrize("fn,scope,args", NEW_SCOPES,
                         ids=[f for f, _, _ in NEW_SCOPES])
def test_new_scopes_wrap_their_functions(test_wrap, fn, scope, args):
    """Each elementwise op the reference leaves unnamed runs in its range,
    and the wrapper returns what the function returns."""
    eng = test_wrap.engine
    p, tabs = eng.params, eng.tabs
    assert scope in trace.SCOPES and fn in trace.SCOPES[scope]
    wrapped = getattr(ops_impl, fn)
    assert wrapped.ckks_scope == scope
    lvl = 3
    q = torch.as_tensor([int(x) for x in p.q_primes[:lvl + 1]])
    rng = np.random.default_rng(5)

    def residues(*lead):
        x = rng.integers(0, 1 << 62, lead + (lvl + 1, p.n)) % \
            q.numpy().reshape(-1, 1)
        return torch.as_tensor(x).int()

    a = residues(2)
    if args == 1:
        rest = ()
    elif args == 2:
        rest = (residues(2),)
    elif args == "pt":
        rest = (residues(),)
    else:
        cols = 4 if args == "consts4" else 2
        c = rng.integers(0, 1 << 62, (lvl + 1, cols)) % \
            q.numpy().reshape(-1, 1)
        rest = (torch.as_tensor(c).int(),)
    with _cpu_profile() as prof:
        got = wrapped(p, tabs, a, *rest)
    assert torch.equal(got, wrapped.__wrapped__(p, tabs, a, *rest))
    assert _ranges(prof) == [(scope, None)]


@pytest.fixture(scope="module")
def round_one(test_wrap):
    """One bit-sliced round at the `test` profile under the CPU profiler:
    the pipeline, its input and output, and the profile."""
    aes = AESFHE128Bitsliced(test_wrap, KEY)
    state = np.random.default_rng(2).integers(
        0, 256, test_wrap.engine.slot_count, dtype=np.uint8)
    st = aes.encrypt_state(state)
    with _cpu_profile() as prof:
        out = aes.encrypt_rounds(st, rounds=1)
    return SimpleNamespace(aes=aes, state=state, st=st, out=out,
                           ranges=_ranges(prof))


def test_bitsliced_round_nests_stage_spans(round_one):
    """ckks.aes.round around ckks.aes.sub_bytes around a primitive's range;
    every stage span under the round but the closing ARK; every range a
    ckks.* name the trace module lists; the round still exact."""
    r = round_one.ranges
    assert ("ckks.aes.round", None) in r
    for stage in ("ckks.aes.ark", "ckks.aes.sub_bytes", "ckks.aes.shift_mix"):
        assert (stage, "ckks.aes.round") in r
    assert ("ckks.aes.ark", None) in r        # ARK(rk1) of a partial run
    assert ("ckks.walsh_subbytes", "ckks.aes.sub_bytes") in r
    names = {n for n, _ in r}
    known = set(trace.SCOPES) | {"ckks.aes.round", "ckks.aes.ark",
                                 "ckks.aes.sub_bytes", "ckks.aes.shift_mix",
                                 "ckks.aes.refresh"}
    assert names <= known
    assert "ckks.aes.refresh" not in names     # no refresh callable
    sc = len(round_one.state)
    want = np.concatenate([aes128_partial(round_one.state[b:b + 16], KEY, 1)
                           for b in range(0, sc, 16)])
    assert np.array_equal(round_one.aes.decrypt_state(round_one.out), want)


@pytest.mark.parametrize("need,refreshes", [(15, True), (1, False)])
def test_refresh_span_only_when_it_refreshes(round_one, need, refreshes):
    """The pair-packed refresh opens ckks.aes.refresh around its pack,
    refresh calls and unpack only when the state lacks `need` levels (an
    identity stands in for the bootstrap)."""
    aes = round_one.aes
    calls = []
    aes.refresh = lambda ct: calls.append(ct.level) or ct
    try:
        with _cpu_profile() as prof:
            aes._refresh(round_one.st, need)
    finally:
        aes.refresh = None
    r = _ranges(prof)
    assert len(calls) == (4 if refreshes else 0)
    # every primitive's range of the refresh opens inside its span
    assert [n for n, p in r if p is None] == (["ckks.aes.refresh"]
                                              if refreshes else [])
    assert len(r) > 1 if refreshes else r == []


@pytest.fixture(scope="module")
def boot_wrap():
    w = EngineWrapper(XORConfig(params=CKKSParams(**BOOT_CHAIN),
                                device="cpu", rotation_steps=(),
                                use_bootstrap=True),
                      rng=np.random.default_rng(3))
    eng = w.engine
    sc = eng.slot_count
    rng = np.random.default_rng(9)
    p0, p1 = (1.0 - 2.0 * rng.integers(0, 2, sc) for _ in range(2))
    ct = eng.add(eng._drop(eng.encrypt(p0, w.public_key), 0),
                 eng.multiply_i(eng._drop(eng.encrypt(p1, w.public_key), 0)))
    return SimpleNamespace(w=w, ct=ct, msg=p0 + 1j * p1)


@pytest.mark.parametrize("profiled", [True, False])
def test_bootstrap_phase_counters(boot_wrap, profiled):
    """Under the profiler an eager bootstrap adds each phase's host-clock
    nanoseconds (the CPU runs synchronously) inside ckks.boot's phase
    spans; without it the counters stay and no range opens."""
    w, eng = boot_wrap.w, boot_wrap.w.engine
    before = {k: eng.counters[k] for k in PHASE_KEYS}
    if profiled:
        with _cpu_profile() as prof:
            out = w.bootstrap(boot_wrap.ct)
        r = _ranges(prof)
        for p in tbs._PhaseTimer.PHASES:
            assert (f"ckks.boot.{p}", "ckks.boot") in r
        assert ("ckks.boot", None) in r
        assert all(eng.counters[k] > before[k] for k in PHASE_KEYS)
    else:
        out = w.bootstrap(boot_wrap.ct)
        assert {k: eng.counters[k] for k in PHASE_KEYS} == before
    assert np.max(np.abs(w.decrypt(out) - boot_wrap.msg)) < 0.35


def test_phase_timer_off_stamps_nothing(boot_wrap):
    """A timer made with no profiler and no capture is off: its marks take
    no time stamp and `add` leaves the counters."""
    eng = boot_wrap.w.engine
    before = dict(eng.counters)
    pt = tbs._PhaseTimer(eng, boot_wrap.ct.data)
    assert not pt.on
    pt.start()
    for p in pt.PHASES:
        with pt.phase(p):
            pass
    pt.add()
    assert pt.stamps == [None] * 4
    assert eng.counters == before
