"""The MoE, MLA, cross-attention and embeddings-input families of the port
against the JAX package, on the same weights (atol = rtol = 1e-4 on
logits and caches, float32).

The smoke configs of mixtral-8x22b (moe blocks, sliding window 32),
deepseek-moe-16b (a dense first layer, then moe blocks with shared experts:
a plan of two groups), minicpm3-4b (MLA attention), musicgen-large (a
prefill of frame embeddings) and llama-3.2-vision-90b (a cross block to the
stub encoder states after every four dense blocks) run through the
``Model`` API: prefill, the tree-masked ``spec_forward``, ``decode_step``
and a 16-token greedy stream.  Tree speculation on mixtral, minicpm3 and
deepseek-moe (``tests/test_engine.py``'s family oracle) gives the
reference's tokens and ``SpecStats`` and the port's own greedy decode.
The two-group and the MLA caches go through ``apply_moves`` in one
``kv_move_leaves`` call and through ``install_slot`` / ``zero_slot``, and a
continuous-batching run of deepseek-moe serves every request as its solo
``generate()``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.core import kv as jkv
from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro.kernels.ref import kv_move_rows_ref
from repro.models.api import make_model as jmake_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import kv
from repro_torch.core.engine import SpecConfig, SpecEngine
from repro_torch.kernels import ops
from repro_torch.models.api import make_model
from repro_torch.serving import ContinuousBatchingRuntime, Request, VirtualClock
from test_torch_model import unbox

S_MAX = 64
TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = ["mixtral-8x22b", "deepseek-moe-16b", "minicpm3-4b", "musicgen-large",
            "llama-3.2-vision-90b"]
ENGINE_FAMILIES = ["mixtral-8x22b", "minicpm3-4b", "deepseek-moe-16b"]


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, JAX params, port model, port params), lm_heads x4."""
    out = {}
    for seed, name in enumerate(FAMILIES):
        jm = jmake_model(jget_config(name, smoke=True))
        jp = jm.init(jax.random.PRNGKey(seed))
        jp["lm_head"].value = jp["lm_head"].value * 4.0  # peaked, as the serving weights
        cfg = get_config(name, smoke=True)
        out[name] = (jm, jp, make_model(cfg, "cpu"), params_from_numpy(cfg, unbox(jp), "cpu"))
    return out


def _leaves(cache):
    """A cache's leaves in the reference's order (groups, blocks, sorted keys)."""
    if isinstance(cache, dict):
        return [x for k in sorted(cache) for x in _leaves(cache[k])]
    if isinstance(cache, (list, tuple)):
        return [x for c in cache for x in _leaves(c)]
    return [cache]


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)


def _caches_close(tc, jc, what):
    tl, jl = _leaves(tc["groups"]), jax.tree.leaves(jc["groups"])
    assert len(tl) == len(jl) and tl
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert tuple(a.shape) == tuple(b.shape), (what, i)
        _close(a, b, f"{what} cache leaf {i}")


def _prompt(cfg, B=2, P=8, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)


def _prefill(models, name, prompt, seed=0):
    """(JAX logits, JAX cache, port logits, port cache) of one prefill: the
    vision model with seeded encoder states, musicgen from the embeddings of
    ``prompt`` plus seeded noise (a frame stream, not a token stream)."""
    jm, jp, tm, tp = models[name]
    cfg = tm.cfg
    rng = np.random.default_rng(100 + seed)
    B, P = prompt.shape
    jkw, tkw = {}, {}
    if tm.needs_enc():
        enc = rng.normal(size=(B, cfg.n_enc_tokens, cfg.d_model)).astype(np.float32)
        jkw["enc"], tkw["enc"] = jnp.asarray(enc), enc
    if not cfg.embed_inputs:
        emb = np.asarray(jp["embed"].value)[prompt] + \
            0.1 * rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
        jkw["embeds"], tkw["embeds"] = jnp.asarray(emb), emb
    else:
        jkw["tokens"], tkw["tokens"] = jnp.asarray(prompt), prompt
    jl, jc = jm.prefill(jp, S_max=S_MAX, **jkw)
    tl, tc = tm.prefill(tp, S_max=S_MAX, **tkw)
    return jl, jc, tl, tc


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_reference(models, name):
    jm, jp, tm, tp = models[name]
    prompt = _prompt(tm.cfg)
    jl, jc, tl, tc = _prefill(models, name, prompt)
    _close(tl, jl, "prefill logits")
    _caches_close(tc, jc, "prefill")
    assert tc["len"] == int(jc["len"]) == prompt.shape[1]
    assert tm.needs_enc() == jm.needs_enc() == (name == "llama-3.2-vision-90b")


@pytest.mark.parametrize("name", FAMILIES)
def test_spec_forward_matches_reference(models, name):
    """A tree-shaped forward after the prefill: rows written out of order,
    one row skipped (-1), one query fully masked, ancestor subsets."""
    jm, jp, tm, tp = models[name]
    B, P, n = 2, 8, 5
    prompt = _prompt(tm.cfg, B, P)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tm.cfg.vocab_size, size=(B, n)).astype(np.int32)
    rows = np.array([[P - 1, P, -1, P + 2, P + 1], [P - 1, P + 1, P, P + 3, -1]], np.int32)
    positions = np.array([[P - 1, P, P, P + 1, P + 2]] * B, np.int32)
    mask = np.zeros((B, n, S_MAX), bool)
    mask[:, :, :P - 1] = True
    for b in range(B):
        for i in range(n):
            if rows[b, i] >= 0:
                mask[b, i, rows[b, i]] = True
                prev = rows[b, :i][rows[b, :i] >= 0]
                mask[b, i, prev] = rng.random(len(prev)) < 0.6
    mask[1, 4] = False  # a query that sees nothing attends to nothing
    _, jc, _, tc = _prefill(models, name, prompt)
    jl, jc = jm.spec_forward(jp, jc, *map(jnp.asarray, (tokens, positions, rows, mask)))
    tl, tc = tm.spec_forward(tp, tc, tokens, positions, rows, mask)
    _close(tl, jl, "spec_forward logits")
    _caches_close(tc, jc, "spec_forward")


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_step_matches_reference(models, name):
    jm, jp, tm, tp = models[name]
    prompt = _prompt(tm.cfg, seed=3)
    _, jc, _, tc = _prefill(models, name, prompt, seed=3)
    rng = np.random.default_rng(3)
    for step in range(3):
        tok = rng.integers(0, tm.cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), S_MAX)
        tl, tc = tm.decode_step(tp, tc, tok, S_MAX)
        _close(tl, jl, f"decode_step {step} logits")
        assert tc["len"] == int(jc["len"])
    _caches_close(tc, jc, "decode_step")


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_stream_matches_reference(models, name):
    """16 greedy tokens after the prefill; mixtral's prompt of 24 takes the
    stream past its sliding window of 32."""
    jm, jp, tm, tp = models[name]
    prompt = _prompt(tm.cfg, P=24 if tm.cfg.sliding_window else 8, seed=4)
    jl, jc, tl, tc = _prefill(models, name, prompt, seed=4)
    step = jax.jit(lambda c, t: jm.decode_step(jp, c, t, S_MAX))
    jcur = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    cur = tl[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    jout, out = [np.asarray(jcur)], [cur.numpy()]
    for _ in range(15):
        jl, jc = step(jc, jcur)
        tl, tc = tm.decode_step(tp, tc, cur, S_MAX)
        jcur = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        cur = tl[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        jout.append(np.asarray(jcur))
        out.append(cur.numpy())
    np.testing.assert_array_equal(np.concatenate(out, 1), np.concatenate(jout, 1))
    if tm.cfg.sliding_window:
        assert prompt.shape[1] + 16 > tm.cfg.sliding_window


def test_prefill_of_token_embeddings_equals_the_token_prefill(models):
    """musicgen: frame embeddings that are the table's rows give the token
    prefill's logits and cache bit for bit."""
    _, _, tm, tp = models["musicgen-large"]
    prompt = _prompt(tm.cfg)
    tl, tc = tm.prefill(tp, prompt, S_max=S_MAX)
    el, ec = tm.prefill(tp, embeds=tp.embed[torch.tensor(prompt).long()], S_max=S_MAX)
    assert torch.equal(el, tl)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(ec["groups"]), _leaves(tc["groups"])))


def test_cross_model_needs_the_encoder_states(models):
    _, _, tm, tp = models["llama-3.2-vision-90b"]
    with pytest.raises(ValueError, match="encoder states"):
        tm.prefill(tp, _prompt(tm.cfg), S_max=S_MAX)


@pytest.mark.parametrize("name", ENGINE_FAMILIES)
def test_tree_speculation_matches_reference(models, name):
    """The twin of tests/test_engine.py's family oracle: self-draft, parallel
    mode.  mixtral's 32 new tokens take it past its window."""
    jm, jp, tm, tp = models[name]
    cfg = tm.cfg
    prompt = (np.arange(1, 7, dtype=np.int32) % cfg.vocab_size).reshape(1, 6)
    kw = dict(bs=8, w=4, c=2, d=2, n_cap=64, mode="parallel",
              max_new=32 if cfg.sliding_window else 12)
    jout, jst = JSpecEngine(jm, jm, JSpecConfig(**kw), S_max_t=256,
                            S_max_d=256).session(jp, jp).generate(prompt)
    out, st = SpecEngine(tm, tm, SpecConfig(**kw), S_max_t=256,
                         S_max_d=256).session(tp, tp).generate(prompt)
    assert out == jout
    assert (st.rounds, st.draft_steps) == (jst.rounds, jst.draft_steps)
    np.testing.assert_array_equal(st.emitted_rows, jst.emitted_rows)
    np.testing.assert_array_equal(st.accepted_rows, jst.accepted_rows)
    lg, cache = tm.prefill(tp, prompt, S_max=256)
    greedy = [int(lg[0, -1].argmax())]
    for _ in range(kw["max_new"] - 1):
        lg, cache = tm.decode_step(tp, cache, torch.tensor([[greedy[-1]]], dtype=torch.int32),
                                   256)
        greedy.append(int(lg[0, -1].argmax()))
    assert out[0] == greedy
    assert st.accepted > 0, "self-draft must accept draft tokens"


def _cache_model(name):
    """The smoke model of ``name``; deepseek-moe's with 4 layers, so that
    its two groups repeat their units 1 and 3 times."""
    cfg = get_config(name, smoke=True)
    if cfg.first_k_dense:
        cfg = dataclasses.replace(cfg, n_layers=4)
    return make_model(cfg, "cpu")


def _random_cache(model, B, seed):
    """A cache of ``model`` with every leaf drawn at random."""
    rng = np.random.default_rng(seed)
    groups = model.init_cache(B, 16)["groups"]
    leaves = (torch.tensor(rng.normal(size=x.shape).astype(np.float32)) for x in _leaves(groups))
    return {"len": 5, "groups": kv._unflatten(groups, leaves)}


def _to_jax(cache):
    return {"len": cache["len"],
            "groups": jax.tree.map(lambda t: jnp.asarray(t.numpy()), cache["groups"])}


CACHE_FAMILIES = ["deepseek-moe-16b", "minicpm3-4b", "llama-3.2-vision-90b"]


@pytest.mark.parametrize("name", CACHE_FAMILIES)
def test_apply_moves_is_one_call_for_every_group(name, monkeypatch):
    """Every row leaf of every group (deepseek-moe: k and v of its dense
    group and of its moe group, U 1 and 3; minicpm3: the latent ckv and
    krope) goes to one ``kv_move_leaves`` call, each moved as the
    reference's ``kv_move_rows_ref`` moves it; the vision model's encoder
    K/V are no row leaves and stay as they were."""
    cache = _random_cache(_cache_model(name), 2, seed=5)
    before = [x.clone() for x in _leaves(cache["groups"])]
    src = torch.tensor([[1, 2, 9, 4], [3, -1, 0, 7]], dtype=torch.int32)
    dst = torch.tensor([[5, 6, 2, 8], [0, 1, 12, 2]], dtype=torch.int32)
    mask = torch.tensor([[True, True, True, False], [True, True, True, True]])
    calls = []
    real = ops.kv_move_leaves

    def spy(leaves, *a, **kw):
        calls.append([tuple(x.shape) for x in leaves])
        return real(leaves, *a, **kw)

    monkeypatch.setattr(ops, "kv_move_leaves", spy)
    out = kv.apply_moves(cache, src, dst, mask, donate=True)
    keys = [k for unit in cache["groups"] for blk in unit for k in sorted(blk)]
    rows = [k in kv.ROW_KEYS for k in keys]
    assert len(calls) == 1 and len(calls[0]) == sum(rows)
    if name == "deepseek-moe-16b":
        assert sorted({shape[0] for shape in calls[0]}) == [1, 3]
    plan = [jnp.asarray(t.numpy()) for t in (src, dst, mask)]
    for key, row, a, got in zip(keys, rows, before, _leaves(out["groups"])):
        want = np.asarray(kv_move_rows_ref(jnp.asarray(a.numpy()), *plan)) if row else a.numpy()
        np.testing.assert_array_equal(got.numpy(), want, err_msg=key)


@pytest.mark.parametrize("name", CACHE_FAMILIES)
def test_install_and_zero_slot_match_reference(name, monkeypatch):
    """``install_slot`` / ``zero_slot`` write batch row ``slot`` of every
    leaf of every group (latent rows, encoder K/V) as the reference does,
    each in one ``slot_write_rows`` call."""
    model = _cache_model(name)
    cache, donor = _random_cache(model, 3, seed=6), _random_cache(model, 1, seed=7)
    calls = []
    real = ops.slot_write_rows

    def spy(leaves, *a, **kw):
        calls.append(len(leaves))
        return real(leaves, *a, **kw)

    monkeypatch.setattr(ops, "slot_write_rows", spy)
    n_leaves = len(_leaves(cache["groups"]))
    want = jkv.install_slot(_to_jax(cache), _to_jax(donor), 1)
    got = kv.install_slot(cache, donor, 1)
    assert calls == [n_leaves]
    for a, b in zip(_leaves(got["groups"]), jax.tree.leaves(want["groups"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got, want = kv.zero_slot(got, 2), jkv.zero_slot(want, 2)
    assert calls == [n_leaves, n_leaves]
    for a, b in zip(_leaves(got["groups"]), jax.tree.leaves(want["groups"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_continuous_batching_serves_each_request_as_its_solo_generate(models):
    """deepseek-moe (two groups, moe blocks), 2 slots, 3 staggered requests
    on a virtual clock: every stream equals its solo ``generate()``."""
    _, _, tm, tp = models["deepseek-moe-16b"]
    eng = SpecEngine(tm, tm, SpecConfig(bs=8, w=4, c=2, d=2, n_cap=64, mode="parallel",
                                        max_new=12), S_max_t=128, S_max_d=128)
    rt = ContinuousBatchingRuntime(eng, tp, tp, n_slots=2, clock=VirtualClock())
    reqs = [Request(rid=i, prompt=((np.arange(1, 7 + 2 * i) * (i + 2) + 1) % 256).astype(np.int32),
                    arrival_s=0.5 * i, max_new=12) for i in range(3)]
    assert rt.submit_trace(reqs) == 3
    res = rt.run()
    assert sorted(res) == [0, 1, 2]
    for r in reqs:
        solo, _ = eng.session(tp, tp).generate(r.prompt.reshape(1, -1), max_new=r.max_new)
        assert res[r.rid] == solo[0], r.rid
