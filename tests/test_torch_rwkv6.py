"""The port's rwkv6 (``repro_torch.models.rwkv6``, the rwkv6 plan of
``models/transformer.py``) and its chain-mode speculation against the JAX
package, on the same weights converted with ``params_from_numpy``.

The WKV recurrence's chunked form equals its stepwise form (the reference's
own contract, tests/test_models_smoke.py); both forms, the time-mix and the
channel-mix with every commit count 0..S match the reference's functions
with the prefix mask ``arange(S) < n``; the smoke model's ``prefill``
(stepwise and chunked), ``chain_forward`` and ``decode_step`` logits and
every cache leaf match at atol = rtol = 1e-4; ``ChainSpecEngine`` emits the
reference's tokens and every ``ChainStats`` field but ``wall_s`` (self-draft
and an independent seed-7 draft, both modes); a chain forward's commit
equals decoding its prefix step by step; and the engine's two snapshots
(the draft's pre-round cache, the target's pre-verify state) keep their
state, checked against clones taken before the round.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.core.chain_engine import ChainConfig as JChainConfig
from repro.core.chain_engine import ChainSpecEngine as JChainSpecEngine
from repro.models import rwkv6 as jrk
from repro.models.api import make_model as jmake_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
from repro_torch.models import rwkv6 as rk
from repro_torch.models.api import make_model
from test_torch_chain import STAT_FIELDS, _caches_close, _leaves, _state_leaves, _unchanged
from test_torch_model import port_greedy, unbox

S_MAX = 64
S_CHAIN = 256
K = 4
TOL = dict(atol=1e-4, rtol=1e-4)


def _rwkv(seed):
    """The reference's rwkv6 smoke model with peaked logits, as
    tests/test_chain_engine.py builds it, and the port's on its weights."""
    jcfg = jget_config("rwkv6-7b", smoke=True)
    jm = jmake_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    jp["lm_head"].value = jp["lm_head"].value * 4.0
    cfg = get_config("rwkv6-7b", smoke=True)
    return jm, jp, make_model(cfg, "cpu"), params_from_numpy(cfg, unbox(jp), "cpu")


@pytest.fixture(scope="module")
def rwkv():
    """(JAX model, JAX target params, JAX seed-7 params, port model, port
    target params, port seed-7 params)."""
    jm, jtp, pm, tp = _rwkv(0)
    _, jdp, _, dp = _rwkv(7)
    return jm, jtp, jdp, pm, tp, dp


# -----------------------------------------------------------------------------
# the WKV recurrence and the two sub-blocks
# -----------------------------------------------------------------------------


def _wkv_inputs(B=2, S=48, H=3, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    logw = -(rng.random((B, S, H, hd)) * 2 + 0.01).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    s0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, s0


def test_wkv_chunked_equals_stepwise():
    """tests/test_models_smoke.py's contract on the port: the chunked
    segment-sum form matches the per-step recurrence."""
    r, k, v, logw, u, s0 = map(torch.tensor, _wkv_inputs())
    y1, sf1 = rk._wkv_scan(r, k, v, torch.exp(logw), u, s0)
    y2, sf2 = rk._wkv_chunked(r, k, v, logw, u, s0, chunk=16)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(sf1.numpy(), sf2.numpy(), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("form", ["scan", "chunked", "chunked-uneven"])
def test_wkv_forms_match_reference(form):
    """Each form against the reference's on the same inputs: the stepwise
    scan, the chunked form over three chunks of 16, and a length whose
    chunk halves (S 40: chunks of 8)."""
    S = 40 if form == "chunked-uneven" else 48
    arrays = _wkv_inputs(S=S, seed=len(form))
    r, k, v, logw, u, s0 = map(torch.tensor, arrays)
    jr, jk, jv, jlogw, ju, js0 = map(jnp.asarray, arrays)
    if form == "scan":
        got = rk._wkv_scan(r, k, v, torch.exp(logw), u, s0)
        want = jrk._wkv_scan(jr, jk, jv, jnp.exp(jlogw), ju, js0)
    else:
        got = rk._wkv_chunked(r, k, v, logw, u, s0, chunk=16)
        want = jrk._wkv_chunked(jr, jk, jv, jlogw, ju, js0, chunk=16)
    for g, w, what in zip(got, want, ("y", "state")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what, **TOL)


def _block_params(rwkv, seed):
    """Block 0's reference parameters (numpy, its key names), with the
    bonus, the mixes and the decay base drawn at random so that no term is a
    multiplication by a constant; and the port's layout of the same."""
    jp = rwkv[1]
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v)[0] for k, v in unbox(jp)["groups"][0][0]["tm"].items()}
    for name in ("bonus_u", "mu_tm", "mu_cm"):
        p[name] = rng.random(p[name].shape).astype(np.float32)
    p["decay_base"] = (-6 + rng.normal(size=p["decay_base"].shape)).astype(np.float32)
    jparams = {k: type("P", (), {"value": jnp.asarray(v)})() for k, v in p.items()}
    return jparams, rk.params_from_reference({k: torch.tensor(v) for k, v in p.items()})


@pytest.mark.parametrize("n", range(6))
def test_time_and_channel_mix_commit_matches_the_prefix_mask(rwkv, n):
    """Time-mix and channel-mix on a chain of S 5 from a random state with
    commit count n against the reference's with the mask arange(S) < n:
    outputs (teacher-forced over all S) and the committed state — the WKV
    state after n steps, the token-shift vectors ext[n]."""
    jm = rwkv[0]
    cfg = get_config("rwkv6-7b", smoke=True)
    B, S, d = 2, 5, cfg.d_model
    H, hd = rk._dims(cfg)
    rng = np.random.default_rng(n)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    cache = {"sx_tm": rng.normal(size=(B, d)), "wkv": rng.normal(size=(B, H, hd, hd)),
             "sx_cm": rng.normal(size=(B, d))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    jparams, tparams = _block_params(rwkv, seed=n)
    mask = jnp.broadcast_to(jnp.arange(S) < n, (B, S))
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    tcache = {k: torch.tensor(v) for k, v in cache.items()}
    for name, jfn, tfn in (("time-mix", jrk.rwkv6_time_mix, rk.rwkv6_time_mix),
                           ("channel-mix", jrk.rwkv6_channel_mix, rk.rwkv6_channel_mix)):
        jout, jstate = jfn(jm.cfg, jparams, jnp.asarray(x), jcache, mask)
        tout, tstate = tfn(cfg, tparams, torch.tensor(x), tcache, n)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), err_msg=f"{name} out", **TOL)
        assert sorted(tstate) == sorted(jstate)
        for key in tstate:
            np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]),
                                       err_msg=f"{name} {key}", **TOL)
    assert torch.equal(tcache["wkv"], torch.tensor(cache["wkv"])), "the input state was written"


# -----------------------------------------------------------------------------
# the model
# -----------------------------------------------------------------------------


def _prompt(vocab, B=2, P=8, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, P)).astype(np.int32)


@pytest.mark.parametrize("P", [8, 48])
def test_rwkv6_forwards_match_reference(rwkv, P):
    """prefill (P 8: the stepwise scan; P 48: the chunked form), then a
    chain of 4 committing 2, then two decode steps: logits and every leaf
    (token-shift vectors, WKV state)."""
    jm, jp, _, pm, tp, _ = rwkv
    prompt = _prompt(jm.cfg.vocab_size, P=P)
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S_MAX)
    tl, tc = pm.prefill(tp, prompt, S_max=S_MAX)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill logits", **TOL)
    _caches_close(tc, jc, "prefill")
    u = np.array([[5, 9, 13, 21], [1, 2, 3, 4]], np.int32)
    jl, jc = jm.chain_forward(jp, jc, jnp.asarray(u), 2, S_MAX)
    tl, tc = pm.chain_forward(tp, tc, u, 2, S_MAX)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="chain logits", **TOL)
    _caches_close(tc, jc, "chain_forward")
    for step in range(2):
        tok = u[:, step + 2:step + 3]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), S_MAX)
        tl, tc = pm.decode_step(tp, tc, tok, S_MAX)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"decode_step {step} logits", **TOL)
    _caches_close(tc, jc, "decode_step")


def test_rwkv6_greedy_stream_matches_reference(rwkv):
    from conftest import greedy_reference

    jm, jp, _, pm, tp, _ = rwkv
    prompt = _prompt(jm.cfg.vocab_size, seed=4)
    assert port_greedy(pm, tp, prompt, 12) == greedy_reference(jm, jp, prompt, 12)


def test_chain_state_commit_is_prefix_exact(rwkv):
    """tests/test_chain_engine.py's test: chain_forward(u, n) leaves the
    cache as decoding u[:n] step by step does, every leaf, for n 0..4."""
    _, _, _, pm, tp, _ = rwkv
    prompt = (np.arange(1, 9, dtype=np.int32) % pm.cfg.vocab_size).reshape(1, 8)
    u = np.array([[5, 9, 13, 21]], np.int32)
    for n in range(u.shape[1] + 1):
        _, cache0 = pm.prefill(tp, prompt, S_max=S_MAX)
        _, chain = pm.chain_forward(tp, cache0, u, n, S_MAX)
        ref = cache0
        for i in range(n):
            _, ref = pm.decode_step(tp, ref, u[:, i:i + 1], S_MAX)
        assert chain["len"] == ref["len"] == prompt.shape[1] + n
        for (name, a), (_, b) in zip(_leaves(chain), _leaves(ref)):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=f"n={n} {name}")


# -----------------------------------------------------------------------------
# the engine
# -----------------------------------------------------------------------------

# (draft, mode, prompt start, new tokens): tests/test_chain_engine.py's cases
CASES = [("self", "serial", 1, 24), ("self", "parallel", 1, 24),
         ("seed7", "serial", 2, 20), ("seed7", "parallel", 2, 20)]
# (mode, max_new) -> the reference's engine: its jitted programs serve both drafts
_JAX_ENGINES = {}


@pytest.mark.parametrize("draft,mode,start,max_new", CASES)
def test_chain_engine_matches_reference(rwkv, draft, mode, start, max_new):
    """Tokens, every ChainStats field but wall_s, and the port's own greedy
    decode.  Self-draft accepts whole chains (parallel mode reuses them);
    the seed-7 draft rolls back."""
    jm, jtp, jdp, pm, tp, dp = rwkv
    jparams, params = ((jtp, jtp), (tp, tp)) if draft == "self" else ((jtp, jdp), (tp, dp))
    prompt = (np.arange(start, start + 8, dtype=np.int32) % pm.cfg.vocab_size).reshape(1, 8)
    key = (mode, max_new)
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = JChainSpecEngine(
            jm, jm, JChainConfig(k=K, mode=mode, max_new=max_new), S_CHAIN, S_CHAIN)
    want, jst = _JAX_ENGINES[key].session(*jparams).generate(prompt)
    eng = ChainSpecEngine(pm, pm, ChainConfig(k=K, mode=mode, max_new=max_new), S_CHAIN, S_CHAIN)
    got, st = eng.session(*params).generate(prompt)
    assert got == want
    assert got[0] == port_greedy(pm, tp, prompt, max_new, S_CHAIN)[0]
    assert [getattr(st, f) for f in STAT_FIELDS] == [getattr(jst, f) for f in STAT_FIELDS]
    if draft == "self":
        assert st.compression_ratio > 1.5
        assert (st.reused_chains > 0) == (mode == "parallel")
    else:
        assert st.accepted < st.rounds * (K - 1)  # some chain rolled back


# -----------------------------------------------------------------------------
# the snapshots
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("draft", ["self", "seed7"])
def test_draft_snapshot_survives_the_chain_and_the_lookahead(rwkv, draft):
    """Every round, the pre-round draft cache that the commit recomputes
    from equals a clone taken before its draft chain: the chain's decode
    steps and the parallel lookahead never write its state."""
    _, _, _, pm, tp, dp = rwkv
    eng = ChainSpecEngine(pm, pm, ChainConfig(k=K, mode="parallel", max_new=20),
                          S_CHAIN, S_CHAIN)
    kept, checks = {}, []

    def draft_chain(dparams, dcache, first):
        kept.setdefault(id(dcache), (dcache, _state_leaves(dcache)))
        return ChainSpecEngine._draft_chain(eng, dparams, dcache, first)

    def dcommit(dparams, dcache, u, n):
        if id(dcache) in kept:
            _unchanged(dcache, kept[id(dcache)][1], f"draft snapshot before commit n={n}")
            checks.append(n)
        return ChainSpecEngine._dcommit(eng, dparams, dcache, u, n)

    eng._draft_chain, eng._dcommit = draft_chain, dcommit
    prompt = (np.arange(2, 10, dtype=np.int32) % pm.cfg.vocab_size).reshape(1, 8)
    _, st = eng.session(tp, tp if draft == "self" else dp).generate(prompt)
    assert st.rounds > 0 and checks.count(K) >= st.rounds
    if draft == "seed7":
        assert any(n < K for n in checks)


def test_verify_leaves_the_target_state_untouched(rwkv):
    """The verify (chain_forward with n_commit = 0) never writes the
    pre-round state that the commit recomputes from: checked at every
    commit against a clone taken before the verify."""
    _, _, _, pm, tp, dp = rwkv
    eng = ChainSpecEngine(pm, pm, ChainConfig(k=K, mode="serial", max_new=20),
                          S_CHAIN, S_CHAIN)
    kept, commits = {}, []

    def verify(tparams, tcache, u):
        kept[id(tcache)] = _state_leaves(tcache)
        argmax, rows = ChainSpecEngine._verify(eng, tparams, tcache, u)
        assert rows["len"] == tcache["len"]  # nothing committed
        return argmax, rows

    def tcommit(tparams, tcache, u, n):
        _unchanged(tcache, kept[id(tcache)], f"target before commit n={n}")
        commits.append(n)
        return ChainSpecEngine._tcommit(eng, tparams, tcache, u, n)

    eng._verify, eng._tcommit = verify, tcommit
    prompt = (np.arange(2, 10, dtype=np.int32) % pm.cfg.vocab_size).reshape(1, 8)
    _, st = eng.session(tp, dp).generate(prompt)
    assert len(commits) == st.rounds > 0
