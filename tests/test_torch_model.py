"""The port's dense model (``repro_torch.models``) against the JAX package on
the same weights.

JAX initialises each model; ``params_from_numpy`` converts its parameter
tree.  Prefill, the tree-masked ``spec_forward`` (logits and K/V caches)
and ``decode_step`` must agree at atol = rtol = 1e-4 in float32, and the
greedy streams must be equal token for token.  The qwen2.5 smoke model
carries the QKV bias; its biases and norm weights are drawn at random so
that those paths are not multiplications by one and additions of zero.
The five other dense configs run at their smoke sizes from the port's own
registry: their head groupings G = Hq/Hkv are 2 (llama3-3b, llama3-70b), 1
(deepseek-coder-1.3b), 4 (deepseek-coder-33b) and 4 with one KV head
(granite-20b, MQA).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from conftest import greedy_reference
from repro.configs import get_config as jget_config
from repro.models.api import make_model as jmake_model
from repro.sharding import Param
from repro_torch.configs import PORTED, ModelConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.api import make_model

S_MAX = 64
TOL = dict(atol=1e-4, rtol=1e-4)


def unbox(tree):
    return jax.tree.map(lambda p: np.asarray(p.value), tree,
                        is_leaf=lambda x: isinstance(x, Param))


def port_config(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def models(dense_pair):
    """name -> (JAX model, JAX params, port model, port params)."""
    T, D, tp, dp = dense_pair
    qcfg = jget_config("qwen2.5-14b", smoke=True)
    Q = jmake_model(qcfg)
    qp = Q.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    (unit,) = qp["groups"][0]
    for name in ("bq", "bk", "bv"):
        unit["attn"][name].value = jnp.asarray(
            0.1 * rng.normal(size=unit["attn"][name].value.shape), jnp.float32)
    for name in ("ln1", "ln2"):
        unit[name].value = jnp.asarray(1 + 0.1 * rng.normal(size=unit[name].value.shape),
                                       jnp.float32)
    qp["final_norm"].value = jnp.asarray(1 + 0.1 * rng.normal(size=(qcfg.d_model,)), jnp.float32)
    out = {}
    for name, (jm, jp) in {"dense-target": (T, tp), "dense-draft": (D, dp),
                           "qwen2.5-smoke": (Q, qp)}.items():
        cfg = port_config(jm.cfg)
        out[name] = (jm, jp, make_model(cfg, "cpu"), params_from_numpy(cfg, unbox(jp), "cpu"))
    for seed, name in enumerate(DENSE_CONFIGS, start=3):
        jm = jmake_model(jget_config(name, smoke=True))
        jp = jm.init(jax.random.PRNGKey(seed))
        jp["lm_head"].value = jp["lm_head"].value * 4.0  # peaked, as the serving weights
        cfg = get_config(name, smoke=True)
        out[name] = (jm, jp, make_model(cfg, "cpu"), params_from_numpy(cfg, unbox(jp), "cpu"))
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)


def _caches_close(tc, jc, what):
    for key in ("k", "v"):
        _close(tc["groups"][0][0][key], jc["groups"][0][0][key], f"{what} cache {key}")


def _prompt(cfg, B=2, P=8, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)


DENSE_CONFIGS = ["llama3-3b", "llama3-70b", "deepseek-coder-1.3b", "deepseek-coder-33b",
                 "granite-20b"]
MODELS = ["dense-target", "dense-draft", "qwen2.5-smoke"] + DENSE_CONFIGS


@pytest.mark.parametrize("name", MODELS)
def test_prefill_matches_reference(models, name):
    jm, jp, tm, tp = models[name]
    prompt = _prompt(jm.cfg)
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S_MAX)
    tl, tc = tm.prefill(tp, prompt, S_max=S_MAX)
    _close(tl, jl, "prefill logits")
    _caches_close(tc, jc, "prefill")
    assert tc["len"] == int(jc["len"]) == prompt.shape[1]


@pytest.mark.parametrize("name", MODELS)
def test_spec_forward_matches_reference(models, name):
    """A tree-shaped forward after the prefill: rows written out of order,
    one row skipped (-1), one query fully masked, ancestor subsets."""
    jm, jp, tm, tp = models[name]
    B, P, n = 2, 8, 5
    prompt = _prompt(jm.cfg, B, P)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(B, n)).astype(np.int32)
    rows = np.array([[P - 1, P, -1, P + 2, P + 1], [P - 1, P + 1, P, P + 3, -1]], np.int32)
    positions = np.array([[P - 1, P, P, P + 1, P + 2], [P - 1, P, P, P + 1, P + 2]], np.int32)
    mask = np.zeros((B, n, S_MAX), bool)
    mask[:, :, :P - 1] = True
    for b in range(B):
        for i in range(n):
            if rows[b, i] >= 0:
                mask[b, i, rows[b, i]] = True
                mask[b, i, rows[b, :i][rows[b, :i] >= 0]] = rng.random(int((rows[b, :i] >= 0).sum())) < 0.6
    mask[1, 4] = False  # a query that sees nothing attends to nothing
    _, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S_MAX)
    _, tc = tm.prefill(tp, prompt, S_max=S_MAX)
    jl, jc = jm.spec_forward(jp, jc, *map(jnp.asarray, (tokens, positions, rows, mask)))
    tl, tc = tm.spec_forward(tp, tc, tokens, positions, rows, mask)
    _close(tl, jl, "spec_forward logits")
    _caches_close(tc, jc, "spec_forward")


@pytest.mark.parametrize("name", MODELS)
def test_decode_step_matches_reference(models, name):
    jm, jp, tm, tp = models[name]
    prompt = _prompt(jm.cfg, seed=3)
    _, jc = jm.prefill(jp, tokens=jnp.asarray(prompt), S_max=S_MAX)
    _, tc = tm.prefill(tp, prompt, S_max=S_MAX)
    rng = np.random.default_rng(3)
    for step in range(3):
        tok = rng.integers(0, jm.cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), S_MAX)
        tl, tc = tm.decode_step(tp, tc, tok, S_MAX)
        _close(tl, jl, f"decode_step {step} logits")
        assert tc["len"] == int(jc["len"])
    _caches_close(tc, jc, "decode_step")


def port_greedy(model, params, prompt, n, S_max=256):
    """The port's target-only greedy decode (prefill + decode_step loop)."""
    lg, cache = model.prefill(params, prompt, S_max=S_max)
    cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    out = [cur]
    for _ in range(n - 1):
        lg, cache = model.decode_step(params, cache, cur, S_max)
        cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out.append(cur)
    return torch.cat(out, 1).tolist()


@pytest.mark.parametrize("name", MODELS)
def test_greedy_stream_matches_reference(models, name):
    jm, jp, tm, tp = models[name]
    prompt = _prompt(jm.cfg, seed=4)
    assert port_greedy(tm, tp, prompt, 16) == greedy_reference(jm, jp, prompt, 16)


@pytest.mark.parametrize("arch", PORTED)
def test_configs_are_the_reference_configs(arch):
    for smoke in (False, True):
        jcfg, cfg = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("mixtral-8x22b")
    moe = ModelConfig(name="m", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                      vocab_size=64, block_pattern=("moe",), n_experts=4, moe_top_k=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_model(moe, "cpu").init(0)


# -----------------------------------------------------------------------------
# scatter_rows: the K/V write of a cached forward
# -----------------------------------------------------------------------------

SCATTER_CASES = {  # name -> (row_idx [B, n], row_mask [B, n] or None)
    # a repeated row, a -1 and a masked-off entry that repeats a kept row
    "repeat": ([[3, 5, 3, -1, 7, 5]], [[True, True, True, True, True, False]]),
    # two batch rows: a pair in each, one of them keeps nothing else
    "two-rows": ([[1, 1, 9, 2], [6, -1, 6, 0]], None),
    # every entry of batch row 1 dropped (-1, past S, masked)
    "row-keeps-nothing": ([[4, 2, 2, 0], [-1, 12, 5, 1]],
                          [[True, True, True, True], [True, True, False, False]]),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_rows_sums_repeated_rows_as_the_reference(case):
    """The port's ``scatter_rows`` against the reference's one-hot write on
    the same numpy input: a row written twice holds the sum of both rows
    (exact in f32 for two), dropped entries write nothing and are no
    writers, and every other row is as it was."""
    from repro.models.attention import scatter_rows as jscatter
    from repro_torch.models.attention import scatter_rows

    idx, mask = SCATTER_CASES[case]
    idx = np.asarray(idx, np.int32)
    rng = np.random.default_rng(len(case))
    B, n = idx.shape
    S = 12
    cache = rng.normal(size=(B, S, 2, 3)).astype(np.float32)
    rows = rng.normal(size=(B, n, 2, 3)).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(np.asarray(mask))
    want = np.asarray(jscatter(jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(idx), jmask))
    tmask = None if mask is None else torch.tensor(np.asarray(mask))
    got = scatter_rows(torch.tensor(cache), torch.tensor(rows), torch.tensor(idx), tmask)
    np.testing.assert_array_equal(got.numpy(), want)
    again = scatter_rows(torch.tensor(cache), torch.tensor(rows), torch.tensor(idx), tmask)
    assert torch.equal(again, got)


def test_scatter_rows_without_repeats_writes_each_row_bit_for_bit():
    """No repeated row: every written row holds its entry's bytes, signed
    zeros included, through a plan shared by two caches as a forward
    shares it between k and v."""
    from repro_torch.models.attention import plan_row_writes, scatter_rows

    rng = np.random.default_rng(5)
    rows = rng.normal(size=(2, 4, 3)).astype(np.float32)
    rows[0, 1, :2] = -0.0
    rows[1, 2, 1] = 0.0
    idx = torch.tensor([[2, 6, -1, 0], [7, 1, 3, 8]], dtype=torch.int32)
    plan = plan_row_writes(idx, 8)
    for cache in (torch.zeros(2, 8, 3), torch.full((2, 8, 3), -0.0)):
        before = cache.clone()
        scatter_rows(cache, torch.tensor(rows), idx, plan=plan)
        for b in range(2):
            for i in range(4):
                r = int(idx[b, i])
                if 0 <= r < 8:
                    assert torch.equal(cache[b, r].view(torch.int32),
                                       torch.tensor(rows[b, i]).view(torch.int32))
        written = {(b, int(r)) for b in range(2) for r in idx[b] if 0 <= int(r) < 8}
        for b in range(2):
            for r in range(8):
                if (b, r) not in written:
                    assert torch.equal(cache[b, r].view(torch.int32),
                                       before[b, r].view(torch.int32))
