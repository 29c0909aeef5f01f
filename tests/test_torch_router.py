"""The port's router and device carving (``repro_torch.serving.router``,
``repro_torch.launch.mesh``, ``repro_torch.core.scheduler``) against the
JAX package's, on the ``dense_pair`` weights converted with
``params_from_numpy``.

Oracles: ``tests/test_router.py``, the mesh fallbacks of
``tests/test_runtime_elastic.py`` and ``test_substrate.py``'s allocation
sweep.  For one ``VirtualClock`` trace the reference's and the port's
``ShardedServingRuntime`` serve the same tokens per request on the same
replica, with the same merged summary; two replicas of ONE async engine
serve every request as its solo ``generate()``.  Carving is pure, so it is
tested with explicit lists of CUDA devices on a machine without any.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.core import scheduler as jsched
from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro.launch.mesh import make_serving_mesh
from repro.serving import Request as JRequest
from repro.serving import RequestQueue as JRequestQueue
from repro.serving import ShardedServingRuntime as JSharded
from repro.serving import VirtualClock as JVirtualClock
from repro_torch.configs import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import scheduler
from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
from repro_torch.core.engine import SpecConfig, SpecEngine
from repro_torch.launch.mesh import make_serving_devices
from repro_torch.launch.serve import build_engine
from repro_torch.models.api import make_model
from repro_torch.serving import (
    ContinuousBatchingRuntime,
    Request,
    RequestQueue,
    ShardedServingRuntime,
    VirtualClock,
    fleet_report,
    merge_summary,
)
from test_torch_model import unbox

S_MAX = 256
CFG = dict(bs=8, w=4, c=2, d=2, n_cap=64, mode="parallel", max_new=24)
CUDA8 = [torch.device("cuda", i) for i in range(8)]


def _prompt(k, P=8):
    return ((np.arange(1, P + 1) * k + 3) % 128).astype(np.int32)


@pytest.fixture(scope="module")
def engines(dense_pair):
    """{async_rounds: (jax engine, port engine)}, and both sides' params."""
    T, D, jtp, jdp = dense_pair
    cfgT = ModelConfig(**dataclasses.asdict(T.cfg))
    cfgD = ModelConfig(**dataclasses.asdict(D.cfg))
    pT, pD = make_model(cfgT, "cpu"), make_model(cfgD, "cpu")
    tp = params_from_numpy(cfgT, unbox(jtp), "cpu")
    dp = params_from_numpy(cfgD, unbox(jdp), "cpu")
    out = {asyn: (JSpecEngine(T, D, JSpecConfig(**CFG, async_rounds=asyn),
                              S_max_t=S_MAX, S_max_d=S_MAX),
                  SpecEngine(pT, pD, SpecConfig(**CFG, async_rounds=asyn),
                             S_max_t=S_MAX, S_max_d=S_MAX))
           for asyn in (False, True)}
    return out, (jtp, jdp), (tp, dp)


def _fleets(engines, asyn, n_rep, n_slots, reqs, cap=64):
    """The same trace through the reference's fleet and the port's: the same
    engine object ``n_rep`` times on each side, one virtual clock each."""
    e, (jtp, jdp), (tp, dp) = engines
    je, pe = e[asyn]
    jrt = JSharded([je] * n_rep, jtp, jdp, n_slots=n_slots, clock=JVirtualClock(),
                   queue=JRequestQueue(cap=cap))
    rt = ShardedServingRuntime([pe] * n_rep, tp, dp, n_slots=n_slots, clock=VirtualClock(),
                               queue=RequestQueue(cap=cap))
    jn = jrt.submit_trace(JRequest(**r) for r in reqs)
    assert rt.submit_trace(Request(**r) for r in reqs) == jn
    return jrt, jrt.run(), rt, rt.run()


def _same_summary(s, js):
    assert s.keys() == js.keys()
    for k, v in js.items():
        if isinstance(v, float) and math.isnan(v):
            assert math.isnan(s[k]), k
        else:
            assert s[k] == v, k


# ---------------------------------------------------------------------------
# routing policy (pure, no engine): the reference's cases, both packages
# ---------------------------------------------------------------------------


class _Stub:
    def __init__(self, occupied, n_slots, slack=float("inf")):
        self.occupied, self.n_slots = occupied, n_slots
        self.has_free_slot = occupied < n_slots
        self.load = occupied / n_slots
        self._slack = slack

    def deadline_slack(self, now):
        return self._slack


ROUTE_CASES = [  # (stubs as (occupied, slots, slack), last_dispatch, expected replica)
    ([(1, 2), (0, 2)], None, 1),  # least loaded
    ([(0, 2), (1, 2)], None, 0),
    ([(1, 2), (3, 8)], None, 1),  # the load is a fraction, not a count
    ([(2, 4), (3, 4)], None, 0),
    ([(1, 2), (1, 2)], [2, 1], 1),  # equal load: the oldest last admission
    ([(1, 2), (1, 2)], [1, 2], 0),
    ([(2, 2), (1, 2)], None, 1),  # a full replica is skipped
    ([(2, 2), (2, 2)], None, None),  # a full fleet leaves the queue alone
    ([(1, 2, 2.0), (1, 2, 10.0)], [1, 2], 1),  # slack breaks a load tie before FIFO
    ([(0, 2, 2.0), (1, 2, 10.0)], [1, 2], 0),  # load still dominates
]


@pytest.mark.parametrize("stubs,last,want", ROUTE_CASES)
def test_route_matches_reference(stubs, last, want):
    got = []
    for cls in (JSharded, ShardedServingRuntime):
        rt = object.__new__(cls)
        rt.steppers = [_Stub(*s) for s in stubs]
        rt._last_dispatch = list(last) if last else [-1] * len(stubs)
        got.append(rt._route(0.0))
    assert got == [want, want]


# ---------------------------------------------------------------------------
# end-to-end sharded serving against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("asyn", [False, True], ids=["lockstep", "async"])
def test_sharded_matches_reference_and_solo_generate(engines, asyn):
    """Six staggered requests over 2 replicas x 2 slots: the port serves the
    reference's tokens on the reference's replica for every request, both
    replicas serve, every output equals the port's solo generate(), and the
    merged summary and fleet report are the reference's."""
    reqs = [dict(rid=i, prompt=_prompt(i + 2, P=8 + 4 * (i % 2)), arrival_s=0.4 * i,
                 max_new=12) for i in range(6)]
    jrt, jres, rt, res = _fleets(engines, asyn, 2, 2, reqs)
    assert res == jres and sorted(res) == list(range(6))
    assert [rt.replica_of(i) for i in range(6)] == [jrt.replica_of(i) for i in range(6)]
    assert {rt.replica_of(i) for i in range(6)} == {0, 1}
    e, _, (tp, dp) = engines
    sess = e[asyn][1].session(tp, dp)
    for r in reqs:
        solo, _ = sess.generate(r["prompt"].reshape(1, -1), max_new=r["max_new"])
        assert res[r["rid"]] == solo[0], r["rid"]
    _same_summary(rt.summary(), jrt.summary())
    _same_summary(merge_summary(rt.stats), merge_summary(jrt.stats))
    assert rt.report() == jrt.report() == fleet_report(rt.stats)
    assert "replica 0:" in rt.report() and "fleet:" in rt.report()
    for st, jst in zip(rt.steppers, jrt.steppers):
        assert (st.spec_stats.rounds, st.spec_stats.spec_commits) == (
            jst.spec_stats.rounds, jst.spec_stats.spec_commits)


def test_two_replicas_of_one_async_engine_share_no_round_state(engines):
    """Two replicas of ONE async engine, one slot each, so their rounds are
    always in flight together: nothing of a round lives on the engine, and
    every request equals its solo generate()."""
    e, _, (tp, dp) = engines
    eng = e[True][1]
    rt = ShardedServingRuntime([eng, eng], tp, dp, n_slots=1, clock=VirtualClock())
    reqs = [Request(rid=i, prompt=_prompt(2 * i + 3, P=8 + 4 * (i % 2)), arrival_s=0.0,
                    max_new=14) for i in range(4)]
    rt.submit_trace(reqs)
    results = rt.run()
    assert [rt.replica_of(i) for i in range(4)] == [0, 1, 0, 1]
    sess = eng.session(tp, dp)
    for r in reqs:
        solo, _ = sess.generate(r.prompt.reshape(1, -1), max_new=r.max_new)
        assert results[r.rid] == solo[0], r.rid
    for st in rt.steppers:
        assert st.spec_stats.spec_rounds == st.spec_stats.rounds > 0
        assert st.session._inflight is None


def test_single_replica_fleet_is_the_continuous_runtime(engines):
    e, _, (tp, dp) = engines
    eng = e[False][1]
    reqs = [dict(rid=i, prompt=_prompt(3 * i + 1), arrival_s=0.5 * i, max_new=8)
            for i in range(3)]
    solo_rt = ContinuousBatchingRuntime(eng, tp, dp, n_slots=2, clock=VirtualClock())
    solo_rt.submit_trace(Request(**r) for r in reqs)
    fleet = ShardedServingRuntime([eng], tp, dp, n_slots=2, clock=VirtualClock())
    fleet.submit_trace(Request(**r) for r in reqs)
    assert solo_rt.run() == fleet.run()
    assert fleet.n_replicas == 1


def test_global_queue_cap_and_per_replica_admission_match_reference(engines):
    """One global cap sheds the overflow fleet-wide; a long request on
    replica 0 does not hold a later arrival back from replica 1."""
    reqs = [dict(rid=i, prompt=_prompt(2 * i + 1), arrival_s=0.0, max_new=8) for i in range(5)]
    jrt, jres, rt, res = _fleets(engines, False, 2, 1, reqs, cap=3)
    assert rt.queue.rejected == jrt.queue.rejected == 2
    assert res == jres and sorted(res) == [0, 1, 2]
    reqs = [dict(rid=0, prompt=_prompt(5, P=16), arrival_s=0.0, max_new=20),
            dict(rid=1, prompt=_prompt(6), arrival_s=1.0, max_new=4)]
    jrt, jres, rt, res = _fleets(engines, False, 2, 1, reqs)
    assert res == jres and (rt.replica_of(0), rt.replica_of(1)) == (0, 1)
    assert rt.stats[1].records[1].admitted_s < rt.stats[0].records[0].finish_s


def test_per_replica_params_must_match_engines(engines):
    e, _, (tp, dp) = engines
    with pytest.raises(ValueError, match="at least one"):
        ShardedServingRuntime([], tp, dp, n_slots=1)
    with pytest.raises(ValueError, match="per-replica"):
        ShardedServingRuntime([e[False][1]] * 2, [tp], dp, n_slots=1)


# ---------------------------------------------------------------------------
# device carving (pure) and the engines' device groups
# ---------------------------------------------------------------------------


def test_carving_disjoint_pairs():
    pairs = make_serving_devices(2, 1, replicas=2, devices=CUDA8)
    assert pairs == [((CUDA8[0], CUDA8[1]), (CUDA8[2],)),
                     ((CUDA8[3], CUDA8[4]), (CUDA8[5],))]
    flat = [d for t, dr in pairs for d in t + dr]
    assert len(set(flat)) == len(flat)  # no device shared across replicas or roles
    assert make_serving_devices(6, 2, devices=CUDA8) == (tuple(CUDA8[:6]), tuple(CUDA8[6:]))
    assert make_serving_devices(1, 1, replicas=4, devices=CUDA8)[3] == ((CUDA8[6],),
                                                                       (CUDA8[7],))


def test_carving_fallback_partial_fit_and_replicas_match_reference():
    """The reference's fallbacks (tests/test_runtime_elastic.py) on its one
    CPU device, and the port's on a list of one device: all-or-none shared
    fallback, a 2-tuple for one replica, ValueError for a partial fit and
    for replicas < 1."""
    jpairs = make_serving_mesh(6, 2, replicas=2)
    pairs = make_serving_devices(6, 2, replicas=2, device="cpu")
    assert isinstance(pairs, list) and len(pairs) == len(jpairs) == 2
    for (t, d), (jt, jd) in zip(pairs, jpairs):
        assert t == d == (torch.device("cpu"),) and jt.devices.size == jd.devices.size == 1
    single, jsingle = make_serving_devices(6, 2, device="cpu"), make_serving_mesh(6, 2)
    assert isinstance(single, tuple) and len(single) == len(jsingle) == 2
    assert make_serving_devices(6, 2, replicas=3, devices=CUDA8[:5]) == \
        [((CUDA8[0],), (CUDA8[0],))] * 3  # too few for one replica: all share device 0
    for carve in (lambda: make_serving_mesh(1, 0, replicas=2),
                  lambda: make_serving_devices(1, 0, replicas=2, device="cpu"),
                  lambda: make_serving_devices(2, 2, replicas=3, devices=CUDA8),
                  lambda: make_serving_mesh(6, 2, replicas=0),
                  lambda: make_serving_devices(6, 2, replicas=0, devices=CUDA8)):
        with pytest.raises(ValueError):
            carve()


def test_engines_take_a_shared_pair_and_refuse_a_split_one(engines):
    e, _, _ = engines
    eng = e[False][1]
    cpu = (torch.device("cpu"),)
    shared = SpecEngine(eng.target, eng.draft, eng.cfg, S_MAX, S_MAX,
                        target_devices=cpu, draft_devices=cpu)
    assert shared.device == torch.device("cpu")
    chain = ChainSpecEngine(eng.target, eng.draft, ChainConfig(k=2), S_MAX, S_MAX,
                            target_devices=cpu, draft_devices=cpu)
    assert chain.device == torch.device("cpu")
    for cls, cfg in ((SpecEngine, eng.cfg), (ChainSpecEngine, ChainConfig(k=2))):
        for tg, dg in (((CUDA8[0],), (CUDA8[1],)), (CUDA8[:2], CUDA8[2:3]), (cpu, CUDA8[:1])):
            with pytest.raises(ValueError, match="one process per rank"):
                cls(eng.target, eng.draft, cfg, S_MAX, S_MAX, target_devices=tg,
                    draft_devices=dg)
        with pytest.raises(ValueError, match="live on cpu"):
            cls(eng.target, eng.draft, cfg, S_MAX, S_MAX, target_devices=CUDA8[:1],
                draft_devices=CUDA8[:1])


def test_build_engine_shares_one_engine_over_the_fallback():
    engs, tp, dp, cfgT = build_engine("llama3-8b", "llama3-1b", replicas=3, n_target=1,
                                      n_draft=1, device="cpu")
    assert isinstance(engs, list) and len(engs) == 3
    assert engs[1] is engs[0] and engs[2] is engs[0]
    eng, *_ = build_engine("llama3-8b", "llama3-1b", device="cpu")
    assert isinstance(eng, SpecEngine)


# ---------------------------------------------------------------------------
# the profile-driven allocation (paper §5.5, Fig. 9)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_devices,target_sizes", [(8, None), (5, None), (3, None), (2, None),
                                                     (8, [2, 6, 7]), (4, [1, 3])])
def test_sweep_allocation_matches_reference(n_devices, target_sizes):
    def speed(nt, nd):  # a speed peaked at 6 target devices, ties broken by the first
        return -abs(nt - 6) - 0.01 * nd

    calls, jcalls = [], []
    got = scheduler.sweep_allocation(n_devices, lambda nt, nd: calls.append((nt, nd)) or
                                     speed(nt, nd), target_sizes)
    want = jsched.sweep_allocation(n_devices, lambda nt, nd: jcalls.append((nt, nd)) or
                                   speed(nt, nd), target_sizes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and calls == jcalls
    assert all(nt % 2 == 0 for nt, _ in calls) or target_sizes is not None or n_devices <= 2


def test_sweep_allocation_without_a_feasible_split_fails_as_the_reference():
    for sweep in (scheduler.sweep_allocation, jsched.sweep_allocation):
        with pytest.raises(AssertionError, match="no feasible allocation"):
            sweep(4, lambda nt, nd: 1.0, target_sizes=[4, 5])


@pytest.mark.parametrize("t_draft,t_target", [(3e-3, 10e-3), (10e-3, 3e-3), (1e-3, 1e-3),
                                              (2e-3, 9.5e-3)])
def test_choose_depth_matches_reference(t_draft, t_target):
    prof = scheduler.ProfileResult(t_draft_s=t_draft, t_target_s=t_target)
    jprof = jsched.ProfileResult(t_draft_s=t_draft, t_target_s=t_target)
    assert scheduler.candidate_depths(prof) == jsched.candidate_depths(jprof)
    for speeds in ({1: 1.0, 2: 2.0}, {3: 5.0, 4: 4.0}):
        def run(d):
            return speeds.get(d, float(d))
        assert scheduler.choose_depth(run, prof) == jsched.choose_depth(run, jprof)


def test_profile_times_calls_warm_then_timed():
    calls = {"d": 0, "t": 0}
    prof = scheduler.profile_times(lambda: calls.__setitem__("d", calls["d"] + 1),
                                   lambda: calls.__setitem__("t", calls["t"] + 1), iters=3,
                                   device="cpu")
    assert calls == {"d": 5, "t": 5}  # 2 warm-up calls + 3 timed, as the reference
    assert prof.t_draft_s >= 0 and prof.t_target_s >= 0 and prof.ratio >= 0
