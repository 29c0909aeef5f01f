"""The port's continuous-batching runtime (``repro_torch.serving``) against
the JAX package's, on the ``dense_pair`` weights converted with
``params_from_numpy``.

On one ``VirtualClock`` trace the port serves, lockstep and with async
rounds, exactly the reference's outputs, and each equals the port's own
solo ``generate()``; every ``summary()`` field is equal (a virtual clock
reads no wall time).  Slot recycling leaks nothing and ``release_slot``
touches one row.  The scheduler's adaptive-depth and EDF cases of
``tests/test_scheduler.py`` run on the port's copies, and the serve CLI
serves a continuous async trace on the CPU and checks itself.  Overlap is
asserted structurally, never against a wall-clock threshold.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro.serving import ContinuousBatchingRuntime as JRuntime
from repro.serving import Request as JRequest
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import VirtualClock as JVirtualClock
from repro_torch.configs import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import kv
from repro_torch.core.engine import SpecConfig, SpecEngine
from repro_torch.launch import serve
from repro_torch.models.api import make_model
from repro_torch.obs import NOOP_SPAN, Tracer, phase_breakdown
from repro_torch.serving import (
    AdaptiveDepthController,
    ContinuousBatchingRuntime,
    Request,
    RequestQueue,
    SchedulerConfig,
    VirtualClock,
)
from test_torch_model import unbox

S_MAX = 256
CFG = dict(bs=8, w=4, c=2, n_cap=64, mode="parallel", max_new=24)


def _prompt(k, P=8):
    return ((np.arange(1, P + 1) * k + 3) % 128).astype(np.int32)


@pytest.fixture(scope="module")
def engines(dense_pair):
    """{(async_rounds, d): (jax engine, port engine)} on the independent
    draft, and both sides' params."""
    T, D, jtp, jdp = dense_pair
    cfgT = ModelConfig(**dataclasses.asdict(T.cfg))
    cfgD = ModelConfig(**dataclasses.asdict(D.cfg))
    pT, pD = make_model(cfgT, "cpu"), make_model(cfgD, "cpu")
    tp = params_from_numpy(cfgT, unbox(jtp), "cpu")
    dp = params_from_numpy(cfgD, unbox(jdp), "cpu")
    out = {}
    for asyn in (False, True):
        for d in (2, 4):
            out[asyn, d] = (
                JSpecEngine(T, D, JSpecConfig(**CFG, d=d, async_rounds=asyn),
                            S_max_t=S_MAX, S_max_d=S_MAX),
                SpecEngine(pT, pD, SpecConfig(**CFG, d=d, async_rounds=asyn),
                           S_max_t=S_MAX, S_max_d=S_MAX))
    return out, (jtp, jdp), (tp, dp)


def _requests(n=5, max_new=16, deadlines=False):
    return [dict(rid=i, prompt=_prompt(i + 1, P=8 + 4 * (i % 2)), arrival_s=0.7 * i,
                 max_new=max_new,
                 deadline_s=0.7 * i + 40.0 if deadlines and i % 2 else None)
            for i in range(n)]


def _serve_both(engines, asyn, d, reqs, scheduler=None):
    """The same trace through the reference's runtime and the port's."""
    e, (jtp, jdp), (tp, dp) = engines
    je, pe = e[asyn, d]
    jrt = JRuntime(je, jtp, jdp, n_slots=2, clock=JVirtualClock(),
                   scheduler=None if scheduler is None else JSchedulerConfig(**scheduler))
    rt = ContinuousBatchingRuntime(pe, tp, dp, n_slots=2, clock=VirtualClock(),
                                   scheduler=None if scheduler is None else
                                   SchedulerConfig(**scheduler))
    assert jrt.submit_trace(JRequest(**r) for r in reqs) == len(reqs)
    assert rt.submit_trace(Request(**r) for r in reqs) == len(reqs)
    return jrt, jrt.run(), rt, rt.run()


def _solo(engines, asyn, d, r):
    e, _, (tp, dp) = engines
    out, _ = e[asyn, d][1].session(tp, dp).generate(r["prompt"].reshape(1, -1),
                                                    max_new=r["max_new"])
    return out[0]


def _same_summary(s, js):
    assert s.keys() == js.keys()
    for k, v in js.items():
        if isinstance(v, float) and math.isnan(v):
            assert math.isnan(s[k]), k
        else:
            assert s[k] == v, k


@pytest.mark.parametrize("asyn", [False, True], ids=["lockstep", "async"])
def test_continuous_matches_reference_and_solo_generate(engines, asyn):
    """Five staggered requests through two slots: the port's outputs equal
    the reference runtime's and the port's solo generate(), every summary
    field is equal, and lifetimes overlap (mid-flight admission)."""
    reqs = _requests()
    jrt, jres, rt, res = _serve_both(engines, asyn, 2, reqs)
    assert res == jres and sorted(res) == [0, 1, 2, 3, 4]
    for r in reqs:
        assert res[r["rid"]] == _solo(engines, asyn, 2, r), r["rid"]
    _same_summary(rt.stats.summary(), jrt.stats.summary())
    st, jst = rt.stepper.spec_stats, jrt.stepper.spec_stats
    assert (st.rounds, st.spec_rounds, st.spec_commits, st.draft_steps) == (
        jst.rounds, jst.spec_rounds, jst.spec_commits, jst.draft_steps)
    recs = list(rt.stats.records.values())
    assert any(a.rid != b.rid and a.admit_round < b.finish_round and b.admit_round < a.finish_round
               for a in recs for b in recs), "no overlapping request lifetimes"
    assert max(rt.stats.occupancy_samples) == 2


@pytest.mark.parametrize("asyn", [False, True], ids=["continuous", "async"])
def test_adaptive_depth_matches_reference(engines, asyn):
    """Adaptive depth with deadlined and best-effort traffic over recycled
    slots: outputs equal the reference's and the solo generate(), and the
    controller chose the reference's depth every round."""
    reqs = _requests(deadlines=True)
    jrt, jres, rt, res = _serve_both(engines, asyn, 4, reqs, scheduler=dict(ema_alpha=0.5))
    assert res == jres and sorted(res) == [0, 1, 2, 3, 4]
    for r in reqs:
        assert res[r["rid"]] == _solo(engines, asyn, 4, r), r["rid"]

    def depths(runtime):
        return [v for _, s in runtime.metrics.series_family("serving_round_depth")
                for _, v in s.samples]

    assert depths(rt) == depths(jrt) and set(depths(rt)) <= set(SchedulerConfig().depth_buckets)
    _same_summary(rt.stats.summary(), jrt.stats.summary())


def test_adaptive_depth_reduces_round_cost_on_virtual_clock(engines):
    """With a per-expansion cost, shallow rounds finish the same outputs in
    less virtual time than the fixed d=4."""
    e, _, (tp, dp) = engines
    eng = e[False, 4][1]

    def run(scheduler):
        rt = ContinuousBatchingRuntime(eng, tp, dp, n_slots=2,
                                       clock=VirtualClock(round_dt=1.0, expand_dt=0.25),
                                       scheduler=scheduler)
        rt.submit_trace(Request(rid=i, prompt=_prompt(i + 2), arrival_s=0.0, max_new=12)
                        for i in range(3))
        return rt.run(), rt.clock.now()

    fixed, t_fixed = run(None)
    shallow, t_shallow = run(SchedulerConfig(depth_buckets=(1,)))
    assert shallow == fixed and t_shallow < t_fixed


def test_slot_recycling_leaks_nothing(engines):
    """Two requests one after the other through ONE slot: the second equals
    its solo run, and after the last release every cache row is zero."""
    e, _, (tp, dp) = engines
    eng = e[False, 2][1]
    a, b = _prompt(5, P=12), _prompt(11, P=8)
    rt = ContinuousBatchingRuntime(eng, tp, dp, n_slots=1, clock=VirtualClock())
    rt.submit(Request(rid=0, prompt=a, arrival_s=0.0, max_new=16))
    rt.submit(Request(rid=1, prompt=b, arrival_s=0.0, max_new=16))
    results = rt.run()
    solo, _ = eng.session(tp, dp).generate(b.reshape(1, -1), max_new=16)
    assert results[1] == solo[0], "a retired slot's state leaked into its successor"
    for cache in (rt.state.tcache, rt.state.dcache):
        leaves = kv._flatten(cache["groups"])
        assert leaves and all(not leaf.any() for leaf in leaves)


def test_admit_matches_reference_and_release_touches_one_row(engines):
    """Admission installs the same cache rows and tree rows as the
    reference's; release zeroes exactly the released row."""
    e, (jtp, jdp), (tp, dp) = engines
    je, pe = e[False, 2]
    jsess, sess = je.session(jtp, jdp, n_slots=2), pe.session(tp, dp, n_slots=2)
    for slot, k in ((0, 3), (1, 4)):
        jsess.admit_slot(slot, _prompt(k))
        sess.admit_slot(slot, _prompt(k))
    for cache, jcache in ((sess.state.tcache, jsess.state.tcache),
                          (sess.state.dcache, jsess.state.dcache)):
        for leaf, jleaf in zip(kv._flatten(cache["groups"]), jax.tree.leaves(jcache["groups"])):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf), atol=1e-4, rtol=1e-4)
    for name, f, jf in zip(sess.state.tr._fields, sess.state.tr, jsess.state.tr):
        if f.dtype == torch.float32:  # log-softmax may differ in the last bit
            np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf), err_msg=name)
    before = [x.clone() for x in kv._flatten(sess.state.tcache["groups"])]
    sess.release_slot(0)
    for b4, af in zip(before, kv._flatten(sess.state.tcache["groups"])):
        assert not af[:, 0].any(), "released row not cleared"
        assert torch.equal(af[:, 1], b4[:, 1]), "neighbour row changed"
    assert not sess.state.tr.valid[0].any() and sess.state.tr.valid[1].any()


@pytest.mark.parametrize("asyn", [False, True], ids=["lockstep", "async"])
def test_failing_absorb_leaves_tracer_balanced_and_session_quiescent(engines, asyn):
    e, _, (tp, dp) = engines
    tracer = Tracer(clock=lambda: 0.0)

    def bad_stream(rid, toks, done):
        raise RuntimeError("poisoned stream")

    rt = ContinuousBatchingRuntime(e[asyn, 2][1], tp, dp, n_slots=2, clock=VirtualClock(),
                                   tracer=tracer, stream=bad_stream)
    rt.submit(Request(rid=0, prompt=_prompt(1), max_new=8))
    rt.submit(Request(rid=1, prompt=_prompt(2), max_new=8))
    with pytest.raises(RuntimeError, match="poisoned stream"):
        rt.run()
    assert rt.stepper._round_span is NOOP_SPAN
    rounds = tracer.spans("round")
    assert rounds and all(s.t1 is not None for s in rounds)
    assert rt.stepper.session._inflight is None
    res = rt.stepper.step()
    rt.stepper.abort_round(res)
    assert rt.stepper._round_span is NOOP_SPAN


def test_traced_overlap_async_nonzero_lockstep_zero(engines):
    """The draft's lookahead lies inside the open verify window in async
    rounds, and never in lockstep ones (a structural check on the spans)."""
    e, _, (tp, dp) = engines
    bds = {}
    for asyn in (False, True):
        tracer = Tracer()
        rt = ContinuousBatchingRuntime(e[asyn, 2][1], tp, dp, n_slots=2, clock=VirtualClock(),
                                       tracer=tracer)
        rt.submit_trace(Request(rid=i, prompt=_prompt(i + 1), arrival_s=0.0, max_new=8)
                        for i in range(2))
        rt.run()
        bds[asyn] = phase_breakdown(tracer)
    assert bds[False]["overlap_draft_verify_s"] == 0.0
    assert bds[True]["overlap_draft_verify_s"] > 0.0
    assert bds[True]["phase_s"]["draft_lookahead"] > 0.0


# -----------------------------------------------------------------------------
# the scheduler's host logic (copies of the reference's modules)
# -----------------------------------------------------------------------------


def _req(rid, arrival=0.0, deadline=None, priority=0):
    return Request(rid=rid, prompt=_prompt(rid + 1), arrival_s=arrival,
                   deadline_s=deadline, priority=priority)


def test_edf_pop_orders_by_deadline_then_fifo():
    q = RequestQueue()
    for r in (_req(0, deadline=9.0), _req(1, deadline=3.0), _req(2), _req(3, deadline=3.0)):
        q.submit(r)
    assert [q.pop_ready(0.0).rid for _ in range(4)] == [1, 3, 0, 2]


def test_priority_classes_dominate_deadlines():
    q = RequestQueue()
    for r in (_req(0, deadline=1.0, priority=1), _req(1, deadline=50.0), _req(2)):
        q.submit(r)
    assert [q.pop_ready(0.0).rid for _ in range(3)] == [1, 2, 0]


def test_pop_is_exact_fifo_without_deadlines():
    q = RequestQueue()
    for i in range(5):
        q.submit(_req(i))
    assert [q.pop_ready(0.0).rid for _ in range(5)] == [0, 1, 2, 3, 4]


def test_edf_respects_arrival_gating_and_starvation_bound():
    q = RequestQueue()
    q.submit(_req(0, arrival=0.0, deadline=50.0))
    q.submit(_req(1, arrival=5.0, deadline=5.0 + 1e-9))  # tight but not arrived
    assert q.pop_ready(0.0).rid == 0 and q.pop_ready(0.0) is None
    q = RequestQueue(starvation_s=4.0)
    for r in (_req(0), _req(1, deadline=2.0), _req(2, deadline=3.0)):
        q.submit(r)
    assert q.pop_ready(1.0).rid == 1  # EDF while nobody starves
    assert [q.pop_ready(4.0).rid for _ in range(2)] == [0, 2]  # the oldest has waited 4 s


def test_controller_ema_round_depth_and_lifecycle():
    ctl = AdaptiveDepthController(SchedulerConfig(ema_alpha=0.5), 3, default_depth=4)
    assert ctl.round_depth([True, True, False]) == 4
    ctl.observe(0, 1)
    ctl.observe(0, 0)
    assert ctl.slot_ema(0) == pytest.approx(0.5) and ctl.slot_depth(0) == 1
    ctl.observe(1, 4)
    assert ctl.round_depth([True, False, False]) == 1
    assert ctl.round_depth([True, True, False]) == 4
    ctl.clear_slot(1)
    assert ctl.slot_ema(1) is None


# -----------------------------------------------------------------------------
# the serve CLI
# -----------------------------------------------------------------------------


def test_serve_cli_continuous_async_checks_itself_on_the_cpu(capsys, tmp_path):
    trace_out = tmp_path / "trace.json"
    serve.main(["--device", "cpu", "--continuous", "--async-rounds", "--d", "1",
                "--requests", "3", "--max-new", "8", "--rate", "50",
                "--trace-out", str(trace_out)])
    out = capsys.readouterr().out
    assert out.startswith("continuous: 3/3 requests accepted") and "async rounds" in out
    assert out.count("byte-identical to solo generate()") == 3 and "MISMATCH" not in out
    assert "draft overlapped with verify" in out and trace_out.exists()


@pytest.mark.parametrize("flag", ["--replicas", "--n-target", "--n-draft"])
def test_serve_cli_refuses_the_router_slice(flag, capsys):
    """The router's flags, once refused, now serve: on the one CPU device
    every replica's target and draft share it (the fallback), ``--replicas
    2`` serves through two replicas with the fleet report, and every output
    is checked against its solo generate()."""
    serve.main(["--device", "cpu", "--continuous", flag, "2", "--d", "1", "--requests", "2",
                "--max-new", "6"])
    out = capsys.readouterr().out
    assert out.count("byte-identical to solo generate()") == 2 and "MISMATCH" not in out
    assert ("2 replicas x 2 slots" in out and "fleet: 2 finished" in out) == (flag == "--replicas")
