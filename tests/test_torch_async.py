"""The port's async round (``EngineSession.dispatch_verify`` /
``draft_next_tree`` / ``reconcile``) against the JAX package's, on the
``dense_pair`` weights converted with ``params_from_numpy``.

Twins of ``tests/test_async_engine.py``: the serial-mode error, the
self-draft lookahead that commits, the independent draft that rolls back,
a forced rejection every round, a rejected seed per round against the
lockstep twin, and dispatch while a round is in flight.  Tokens equal the
reference's and the port's lockstep; ``SpecStats`` — ``spec_rounds`` and
``spec_commits`` included — equal the reference's exactly.  On the CPU the
round runs with no streams; the snapshot contract (the lookahead never
writes the retained pre-reroot cache) is pinned here because the port's
forwards write caches in place.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro_torch.configs import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import SpecConfig, SpecEngine, SpecStats
from repro_torch.models.api import make_model
from test_torch_model import port_greedy, unbox

S_MAX = 256
CFG = dict(bs=8, w=4, c=2, d=2, n_cap=64, mode="parallel", max_new=24)
KINDS = ("lock_self", "async_self", "lock_td", "async_td")


def _prompt(k, P=8):
    return ((np.arange(1, P + 1) * k + 3) % 128).astype(np.int32)


@pytest.fixture(scope="module")
def engines(dense_pair):
    """Lockstep and async engines of both packages, self-draft (the seed
    usually commits) and independent draft (reconcile rolls back), with
    each side's weights: {kind: (jax engine, port engine)}, params."""
    T, D, jtp, jdp = dense_pair
    cfgT = ModelConfig(**dataclasses.asdict(T.cfg))
    cfgD = ModelConfig(**dataclasses.asdict(D.cfg))
    pT, pD = make_model(cfgT, "cpu"), make_model(cfgD, "cpu")
    tp = params_from_numpy(cfgT, unbox(jtp), "cpu")
    dp = params_from_numpy(cfgD, unbox(jdp), "cpu")
    out = {}
    for kind in KINDS:
        asyn, self_draft = kind.startswith("async"), kind.endswith("self")
        out[kind] = (
            JSpecEngine(T, T if self_draft else D, JSpecConfig(**CFG, async_rounds=asyn),
                        S_max_t=S_MAX, S_max_d=S_MAX),
            SpecEngine(pT, pT if self_draft else pD, SpecConfig(**CFG, async_rounds=asyn),
                       S_max_t=S_MAX, S_max_d=S_MAX))
    return out, (jtp, jdp), (tp, dp)


def _params(kind, params):
    tp, dp = params
    return (tp, tp) if kind.endswith("self") else (tp, dp)


def _same_stats(st, jst):
    assert (st.rounds, st.draft_steps, st.spec_rounds, st.spec_commits) == (
        jst.rounds, jst.draft_steps, jst.spec_rounds, jst.spec_commits)
    np.testing.assert_array_equal(st.emitted_rows, jst.emitted_rows)
    np.testing.assert_array_equal(st.accepted_rows, jst.accepted_rows)


def test_async_requires_parallel_mode(engines):
    e, _, _ = engines
    eng = e["async_td"][1]
    with pytest.raises(ValueError, match="async_rounds"):
        SpecEngine(eng.target, eng.draft, SpecConfig(**{**CFG, "mode": "serial"},
                                                     async_rounds=True), S_MAX, S_MAX)


@pytest.mark.parametrize("draft,k", [("self", 3), ("td", 5)])
def test_async_generate_matches_reference_and_lockstep(engines, draft, k):
    """Self-draft: the lookahead commits.  Independent draft: it rolls back.
    Either way the tokens equal the reference's, the port's lockstep and
    the greedy decode, and every stat equals the reference's."""
    e, jparams, params = engines
    prompt = _prompt(k).reshape(1, -1)
    je, pe = e[f"async_{draft}"]
    jout, jst = je.session(*_params(draft, jparams)).generate(prompt)
    out, st = pe.session(*_params(draft, params)).generate(prompt)
    lock, _ = e[f"lock_{draft}"][1].session(*_params(draft, params)).generate(prompt)
    assert out == jout == lock
    assert out == port_greedy(pe.target, params[0], prompt, CFG["max_new"])
    _same_stats(st, jst)
    assert st.spec_rounds == st.rounds > 0
    if draft == "self":
        assert st.spec_commits > 0, "the self-draft lookahead never committed"
    else:
        assert st.spec_commits < st.spec_rounds, "the independent draft never rolled back"


def test_forced_rejection_every_round_matches_reference(engines):
    """A predictor that can never match (bonus -1) sends every round down
    the rollback path on both sides: tokens unchanged, no commit."""
    e, jparams, params = engines
    je, pe = e["async_self"]
    prompt = _prompt(7).reshape(1, -1)
    lock, _ = e["lock_self"][1].session(*_params("self", params)).generate(prompt)
    j_real = je._predict
    try:
        je._predict = lambda *a: (lambda p: (p[0], p[1], jnp.full_like(p[2], -1)))(j_real(*a))
        pe._predict = lambda *a: (lambda p: (p[0], p[1], torch.full_like(p[2], -1)))(
            SpecEngine._predict(pe, *a))
        jout, jst = je.session(*_params("self", jparams)).generate(prompt)
        out, st = pe.session(*_params("self", params)).generate(prompt)
    finally:
        je._predict = j_real
        del pe._predict
    assert out == jout == lock
    _same_stats(st, jst)
    assert st.spec_rounds > 0 and st.spec_commits == 0


def test_reconcile_rolls_back_rejected_seed_per_round(engines):
    """The phase API by hand against the lockstep twin: each round's
    prediction is tampered with, so reconcile must re-root from the
    snapshot; every round's result equals the lockstep round's."""
    e, _, params = engines
    lock, asyn = e["lock_self"][1], e["async_self"][1]
    tp, _ = params
    prompt = _prompt(4).reshape(1, -1)
    ref = lock.session(tp, tp, state=lock._prefill_state(tp, tp, prompt))
    sess = asyn.session(tp, tp, state=asyn._prefill_state(tp, tp, prompt))
    for _ in range(3):
        rif = sess.begin_round()
        pa, pn, pb = rif.pred
        rif.pred = (pa, pn, torch.full_like(pb, -1))  # the seed can never match
        st = SpecStats()
        got = sess.reconcile(rif, stats=st)
        assert st.spec_commits == 0 and st.spec_rounds == 1
        want = ref.step()
        np.testing.assert_array_equal(got.emitted, want.emitted)
        np.testing.assert_array_equal(got.n_emitted, want.n_emitted)
        np.testing.assert_array_equal(got.n_accepted, want.n_accepted)


def test_lookahead_leaves_the_snapshot_unchanged(engines):
    """The speculative re-root, fill and regrowth write a fresh cache: the
    retained (tree, draft cache) snapshot equals a clone taken before the
    lookahead, and shares no storage with the lookahead's cache."""
    e, _, params = engines
    eng = e["async_self"][1]
    tp, _ = params
    sess = eng.session(tp, tp, state=eng._prefill_state(tp, tp, _prompt(6).reshape(1, -1)))
    seen = {}

    def spy(dcache, src, dst, mask):
        seen["dcache"] = [x.clone() for x in eng_leaves(dcache)]
        return SpecEngine._spec_kv_move(eng, dcache, src, dst, mask)

    def spy_predict(tr, *a):
        seen["tr"] = [x.clone() for x in tr]
        return SpecEngine._predict(eng, tr, *a)

    def eng_leaves(cache):
        return [cache["groups"][0][0][k] for k in ("k", "v")]

    eng._spec_kv_move, eng._predict = spy, spy_predict
    try:
        rif = sess.begin_round()
    finally:
        del eng._spec_kv_move, eng._predict
    snap_tr, snap_dcache = rif.snapshot
    for got, want in zip(eng_leaves(snap_dcache), seen["dcache"]):
        assert torch.equal(got, want), "the lookahead wrote the snapshot's draft cache"
    for got, want in zip(snap_tr, seen["tr"]):
        assert torch.equal(got, want), "the lookahead changed the snapshot's tree"
    la_dcache = rif.lookahead[1]
    for a, b in zip(eng_leaves(la_dcache), eng_leaves(snap_dcache)):
        assert a.data_ptr() != b.data_ptr()
    sess.reconcile(rif)


def test_dispatch_while_in_flight_is_an_error(engines):
    e, _, params = engines
    eng = e["async_self"][1]
    tp, _ = params
    sess = eng.session(tp, tp, n_slots=1)
    sess.admit_slot(0, _prompt(2))
    rif = sess.begin_round()
    for call in (sess.dispatch_verify, lambda: sess.admit_slot(0, _prompt(3)),
                 lambda: sess.release_slot(0), sess.step):
        with pytest.raises(RuntimeError, match="in flight"):
            call()
    sess.reconcile(rif)
    sess.release_slot(0)  # quiescent again
