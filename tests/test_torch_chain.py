"""The port's chain-mode speculation (``repro_torch.core.chain_engine``) and
the zamba2 hybrid (``repro_torch.models.mamba2``, the shared block) against
the JAX package, on the same weights converted with ``params_from_numpy``.

zamba2's smoke config: ``prefill``, ``chain_forward`` and ``decode_step``
logits and every cache leaf at atol = rtol = 1e-4; the commit of a chain
forward equals decoding its prefix step by step; ``ChainSpecEngine`` emits
the reference's tokens and every ``ChainStats`` field but ``wall_s``, for
zamba2 self-draft and an independent seed-7 draft in both modes and for
the dense pair.  The port's forwards write K/V rows in place, so the two
snapshots the engine keeps — the draft's pre-round cache and the target's
pre-verify cache — are pinned against clones taken before the round.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.core.chain_engine import ChainConfig as JChainConfig
from repro.core.chain_engine import ChainSpecEngine as JChainSpecEngine
from repro.models.api import make_model as jmake_model
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
from repro_torch.models.api import make_model
from test_torch_model import port_greedy, unbox

S_MAX = 64
S_CHAIN = 256
K, MAX_NEW = 4, 20
TOL = dict(atol=1e-4, rtol=1e-4)
STAT_FIELDS = ("rounds", "emitted", "accepted", "reused_chains", "draft_chains")


def _zamba(seed):
    """The reference's zamba2 smoke model with peaked logits, as
    tests/test_chain_engine.py builds it, and the port's on its weights."""
    jcfg = jget_config("zamba2-2.7b", smoke=True)
    jm = jmake_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    jp["lm_head"].value = jp["lm_head"].value * 4.0
    cfg = get_config("zamba2-2.7b", smoke=True)
    return jm, jp, make_model(cfg, "cpu"), params_from_numpy(cfg, unbox(jp), "cpu")


@pytest.fixture(scope="module")
def zamba():
    """(JAX model, JAX target params, JAX seed-7 params, port model, port
    target params, port seed-7 params)."""
    jm, jtp, pm, tp = _zamba(0)
    _, jdp, _, dp = _zamba(7)
    return jm, jtp, jdp, pm, tp, dp


def _leaves(cache):
    """(name, array) of every cache leaf, in the unit's order."""
    return [(f"block {bi} {key}", np.asarray(x)) for bi, blk in enumerate(cache["groups"][0])
            for key, x in sorted(blk.items())]


def _caches_close(tc, jc, what):
    got, want = _leaves(tc), _leaves(jc)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, err_msg=f"{what} {name}", **TOL)
    assert tc["len"] == int(jc["len"])


def _prompt(vocab, B=2, P=8, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, P)).astype(np.int32)


def test_zamba2_forwards_match_reference(zamba):
    """prefill, then a chain of 4 committing 2, then two decode steps:
    logits and every leaf (conv window, SSM state, the shared block's K/V)."""
    jm, jp, _, pm, tp, _ = zamba
    prompt = _prompt(jm.cfg.vocab_size)
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


def test_zamba2_greedy_stream_matches_reference(zamba):
    from conftest import greedy_reference

    jm, jp, _, pm, tp, _ = zamba
    prompt = _prompt(jm.cfg.vocab_size, seed=4)
    assert port_greedy(pm, tp, prompt, 12) == greedy_reference(jm, jp, prompt, 12)


def test_chain_state_commit_is_prefix_exact(zamba):
    """tests/test_chain_engine.py's test on zamba2: chain_forward(u, n)
    leaves the cache as decoding u[:n] step by step does (every leaf, live
    rows of the K/V leaves)."""
    _, _, _, pm, tp, _ = zamba
    prompt = (np.arange(1, 9, dtype=np.int32) % pm.cfg.vocab_size).reshape(1, 8)
    u = np.array([[5, 9, 13, 21]], np.int32)
    for n in range(u.shape[1] + 1):
        _, cache0 = pm.prefill(tp, prompt, S_max=S_MAX)
        _, chain = pm.chain_forward(tp, cache0, u, n, S_MAX)
        _, ref = pm.prefill(tp, prompt, S_max=S_MAX)
        for i in range(n):
            _, ref = pm.decode_step(tp, ref, u[:, i:i + 1], S_MAX)
        assert chain["len"] == ref["len"] == prompt.shape[1] + n
        live = ref["len"]
        for (name, a), (_, b) in zip(_leaves(chain), _leaves(ref)):
            if name.endswith((" k", " v")):
                a, b = a[:, :, :live], b[:, :, :live]
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=f"n={n} {name}")


# -----------------------------------------------------------------------------
# the engine
# -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_models(dense_pair):
    T, D, jtp, jdp = dense_pair
    cfgT = ModelConfig(**dataclasses.asdict(T.cfg))
    cfgD = ModelConfig(**dataclasses.asdict(D.cfg))
    return (T, D, jtp, jdp, make_model(cfgT, "cpu"), make_model(cfgD, "cpu"),
            params_from_numpy(cfgT, unbox(jtp), "cpu"), params_from_numpy(cfgD, unbox(jdp), "cpu"))


CASES = [("zamba2-self", "serial"), ("zamba2-self", "parallel"),
         ("zamba2-seed7", "serial"), ("zamba2-seed7", "parallel"),
         ("dense-pair", "serial"), ("dense-pair", "parallel")]


def _case(name, zamba, dense_models):
    """(JAX target, JAX draft, port target, port draft, JAX params (t, d),
    port params (t, d))."""
    if name == "dense-pair":
        T, D, jtp, jdp, pT, pD, tp, dp = dense_models
        return T, D, pT, pD, (jtp, jdp), (tp, dp)
    jm, jtp, jdp, pm, tp, dp = zamba
    if name == "zamba2-self":
        return jm, jm, pm, pm, (jtp, jtp), (tp, tp)
    return jm, jm, pm, pm, (jtp, jdp), (tp, dp)


_JAX_ENGINES = {}  # (models, mode) -> the reference's engine: its jitted programs serve both drafts


@pytest.mark.parametrize("name,mode", CASES)
def test_chain_engine_matches_reference(name, mode, zamba, dense_models):
    """Tokens, every ChainStats field but wall_s, and the port's own greedy
    decode.  Self-draft accepts whole chains (parallel mode reuses them);
    the seed-7 draft and the dense pair's 1-layer-smaller draft roll back."""
    jT, jD, pT, pD, jparams, params = _case(name, zamba, dense_models)
    prompt = (np.arange(2, 10, dtype=np.int32) % pT.cfg.vocab_size).reshape(1, 8)
    key = (name.split("-")[0], mode)
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = JChainSpecEngine(
            jT, jD, JChainConfig(k=K, mode=mode, max_new=MAX_NEW), S_CHAIN, S_CHAIN)
    want, jst = _JAX_ENGINES[key].session(*jparams).generate(prompt)
    eng = ChainSpecEngine(pT, pD, ChainConfig(k=K, mode=mode, max_new=MAX_NEW), S_CHAIN, S_CHAIN)
    got, st = eng.session(*params).generate(prompt)
    assert got == want
    assert got[0] == port_greedy(pT, params[0], prompt, MAX_NEW, S_CHAIN)[0]
    assert [getattr(st, f) for f in STAT_FIELDS] == [getattr(jst, f) for f in STAT_FIELDS]
    if name == "zamba2-self":
        assert st.compression_ratio > 1.5
        assert (st.reused_chains > 0) == (mode == "parallel")
    if name == "zamba2-seed7":
        assert st.accepted < st.rounds * (K - 1)  # some chain rolled back


def test_chain_engine_refuses_a_batch_and_an_unknown_mode(zamba):
    _, _, _, pm, tp, _ = zamba
    eng = ChainSpecEngine(pm, pm, ChainConfig(k=K, max_new=4), S_CHAIN, S_CHAIN)
    with pytest.raises(ValueError, match="one request"):
        eng.session(tp, tp).generate(np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError, match="mode"):
        ChainSpecEngine(pm, pm, ChainConfig(mode="async"), S_CHAIN, S_CHAIN)


# -----------------------------------------------------------------------------
# the snapshots
# -----------------------------------------------------------------------------


def _state_leaves(cache):
    """Clones of what a kept cache must keep: every mamba2 leaf, and the
    K/V rows below its length."""
    live = cache["len"]
    return [x.clone() if not name.endswith((" k", " v")) else x[:, :, :live].clone()
            for name, x in ((n, t) for bi, blk in enumerate(cache["groups"][0])
                            for n, t in ((f"{bi} {k}", v) for k, v in sorted(blk.items())))]


def _unchanged(cache, before, what):
    for got, want in zip(_state_leaves(cache), before):
        assert torch.equal(got, want), what


@pytest.mark.parametrize("draft", ["self", "seed7"])
def test_draft_snapshot_survives_the_chain_and_the_lookahead(zamba, draft):
    """Every round, the pre-round draft cache that the commit recomputes
    from equals a clone taken before its draft chain: the chain's decode
    steps and the parallel lookahead (a commit of the whole chain and the
    next chain from it) never write its state or its live rows."""
    _, _, _, pm, tp, dp = zamba
    eng = ChainSpecEngine(pm, pm, ChainConfig(k=K, mode="parallel", max_new=MAX_NEW),
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
    out, st = eng.session(tp, tp if draft == "self" else dp).generate(prompt)
    # every round's lookahead (n = k) checked, and a rolled-back round's
    # commit (n < k) too
    assert st.rounds > 0 and checks.count(K) >= st.rounds
    if draft == "seed7":
        assert any(n < K for n in checks)


def test_verify_leaves_the_target_state_untouched(zamba):
    """The verify (chain_forward with n_commit = 0) returns the target's
    K/V rows but never writes the pre-round state that the commit
    recomputes from: checked at every commit against a clone taken before
    the verify."""
    _, _, _, pm, tp, dp = zamba
    eng = ChainSpecEngine(pm, pm, ChainConfig(k=K, mode="serial", max_new=MAX_NEW),
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
