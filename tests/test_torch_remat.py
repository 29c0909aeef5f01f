"""Rematerialisation and chunked full attention, the two reference
behaviours the dry run counts (``repro_torch.models.transformer.apply_model``'s
``remat``, ``models/attention.py``'s query chunks).

* ``remat="full"`` recomputes each unit of the plan in the backward and
  gives the same gradients bit for bit as ``"none"``: on the dense, MoE
  (deepseek-moe's two groups, mixtral), zamba2 and rwkv6 smoke configs in
  one process, and at tp 2 on gloo ranks (each rank's own gradient); its
  loss is the reference's train step's under ``override_flags(remat=
  "full")`` at ``tests/test_torch_train_steps.py``'s 1e-5; on meta it
  saves less for the backward and peaks lower.
* Full attention in query chunks of 512 is the same function: bit for bit
  the unchunked code (kept here as it was) at S <= 512, where there is one
  chunk, and within f32 tolerance (1e-5) at S 1536; the unchunked code is
  held against the reference too (1e-4, ``tests/test_torch_mla.py``'s).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.flags import override_flags
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro.models.api import make_model as jmake_model
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import cost
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import attention, mla
from repro_torch.models.api import make_model
from repro_torch.optim import adamw_init
from repro_torch.parallel.spawn import run_ranks
from test_torch_model import unbox

REMAT_CONFIGS = ("llama3-1b", "deepseek-moe-16b", "mixtral-8x22b", "zamba2-2.7b", "rwkv6-7b")
TP_CONFIGS = ("llama3-1b", "deepseek-moe-16b", "zamba2-2.7b", "rwkv6-7b")
B, S = 2, 8
TOL = dict(atol=1e-4, rtol=1e-4)  # against the reference (tests/test_torch_mla.py's)


def _batch(cfg, seed=7, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)}


@pytest.mark.parametrize("name", REMAT_CONFIGS)
def test_remat_full_gradients_are_bit_equal(name):
    cfg = get_config(name, smoke=True)
    model = make_model(cfg, "cpu")
    params = model.init(0, trainable=True)
    loss0, g0 = loss_and_grads(model, params, _batch(cfg))
    loss1, g1 = loss_and_grads(model, params, _batch(cfg), remat="full")
    assert torch.equal(loss0, loss1)
    for (pname, _), a, b in zip(params.named_parameters(), g0, g1):
        assert torch.equal(a, b), f"{name} {pname}"


def test_remat_refuses_a_cache_and_unknown_policies():
    cfg = get_config("llama3-1b", smoke=True)
    model = make_model(cfg, "cpu")
    params = model.init(0)
    with pytest.raises(ValueError, match="remat must be"):
        model.forward_train(params, tokens=np.zeros((1, 4), np.int32), remat="some")
    from repro_torch.models.transformer import Ctx, apply_model

    h = torch.zeros(1, 4, cfg.d_model)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="no cache"):
        apply_model(cfg, params, h, Ctx(mode="full", make_cache=8, positions=pos), remat="full")


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """Each of 2 gloo ranks' ``workers.remat_counts`` per TP config."""
    calls = [("remat_counts", ({"cfg": get_config(n, smoke=True), "seed": 0,
                                "batch": _batch(get_config(n, smoke=True)),
                                "prompt": _batch(get_config(n, smoke=True))["tokens"][:, :6],
                                "S_max": 16},)) for n in TP_CONFIGS]
    res = run_ranks("repro_torch.parallel.workers:several", 2, (calls,),
                    workdir=tmp_path_factory.mktemp("remat_tp2"), device="cpu", timeout_s=240)
    return {n: [r[i] for r in res] for i, n in enumerate(TP_CONFIGS)}


@pytest.mark.parametrize("name", TP_CONFIGS)
def test_remat_full_gradients_are_bit_equal_at_tp2(tp2, name):
    for rank in tp2[name]:
        for a, b in zip(rank["grads"]["none"], rank["grads"]["full"]):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} rank {rank['rank']}")


@pytest.mark.parametrize("name", ("llama3-1b",))
def test_remat_full_loss_matches_reference(name):
    jm = jmake_model(jget_config(name, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(name, smoke=True)
    model = make_model(cfg, "cpu")
    params = params_from_numpy(cfg, unbox(jp), "cpu").requires_grad_(True)
    batch = _batch(cfg)
    with override_flags(remat="full"):
        jstep = jax.jit(jmake_train_step(jm.cfg, jm))
        _, _, jloss = jstep(jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, loss = make_train_step(cfg, model, remat="full")(params, adamw_init(params), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_remat_saves_less_and_peaks_lower_on_meta():
    """llama3-1b's smoke config at B 4 x S 128, where activations, not the
    weights, set the forward + backward's peak."""
    cfg = get_config("llama3-1b", smoke=True)
    model = make_model(cfg, "meta")
    params = model.init(0, trainable=True)
    batch = {"tokens": torch.empty((4, 129), dtype=torch.int32, device="meta")}
    got = {}
    for remat in ("none", "full"):
        got[remat], _ = cost.count(lambda p, b, r=remat: loss_and_grads(model, p, b, r),
                                   params, batch)
    assert got["full"].live_at_backward < got["none"].live_at_backward
    assert got["full"].peak_bytes < got["none"].peak_bytes
    assert got["full"].argument_bytes == got["none"].argument_bytes
    assert got["full"].flops["backward"] > got["none"].flops["backward"]  # the recompute
    assert got["full"].flops["forward"] == got["none"].flops["forward"]


# -----------------------------------------------------------------------------
# chunked full attention
# -----------------------------------------------------------------------------


def plain_attention_full(cfg, p, x, positions):
    """``attention_full`` as it was before the query chunks: the whole
    [B, S, S] mask and score tensor at once."""
    q, k, v = attention._project_qkv(cfg, p, x, positions)
    m = positions[:, None, :] <= positions[:, :, None]
    if cfg.sliding_window:
        m &= positions[:, None, :] > (positions[:, :, None] - cfg.sliding_window)
    return attention._out_proj(p, attention._attend(q, k, v, m)), (k, v)


def plain_mla_full(cfg, p, x, positions):
    """``mla_full`` as it was before the query chunks."""
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    q_nope, q_rope = mla._queries(cfg, p, x, positions)
    c_kv, k_rope = mla._latents(cfg, p, x, positions)
    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uk"])
    v = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uv"])
    scores = (torch.einsum("bnhk,bshk->bhns", q_nope, k_nope)
              + torch.einsum("bnhk,bsk->bhns", q_rope, k_rope)) * scale
    mask = (positions[:, None, :] <= positions[:, :, None])[:, None]
    probs = torch.softmax(torch.where(mask, scores.float(), -1e30), dim=-1).to(v.dtype)
    return mla._out(p, torch.einsum("bhns,bshk->bnhk", probs, v)), (c_kv, k_rope)


def _inputs(cfg, n, seed, b=1):
    x = np.random.default_rng(seed).normal(size=(b, n, cfg.d_model)).astype(np.float32)
    return x, np.broadcast_to(np.arange(n, dtype=np.int32), (b, n))


@pytest.fixture(scope="module", params=("qwen2.5-14b", "mixtral-8x22b"))
def gqa(request):
    """A GQA layer of the smoke config (mixtral's has a sliding window),
    both sides' weights."""
    jcfg = jget_config(request.param, smoke=True)
    jp = jattn.init_attention(jcfg, jax.random.PRNGKey(0))
    p = {k: torch.tensor(v) for k, v in unbox(jp).items()}
    return jcfg, jp, ModelConfig(**dataclasses.asdict(jcfg)), p


@pytest.fixture(scope="module")
def mla_layer():
    jcfg = jget_config("minicpm3-4b", smoke=True)
    jp = jmla.init_mla(jcfg, jax.random.PRNGKey(0))
    p = {k: torch.tensor(v) for k, v in unbox(jp).items()}
    return jcfg, jp, ModelConfig(**dataclasses.asdict(jcfg)), p


@pytest.mark.parametrize("n", (7, 512))
def test_chunked_attention_is_bit_equal_with_one_chunk(gqa, n):
    _, _, cfg, p = gqa
    x, pos = (torch.tensor(a) for a in _inputs(cfg, n, 1))
    assert attention.attn_chunk(n) == n
    out, (k, v) = attention.attention_full(cfg, p, x, pos)
    want, (wk, wv) = plain_attention_full(cfg, p, x, pos)
    assert torch.equal(out, want) and torch.equal(k, wk) and torch.equal(v, wv)


def test_chunked_attention_matches_unchunked_and_reference_at_1536(gqa):
    jcfg, jp, cfg, p = gqa
    x, pos = _inputs(cfg, 1536, 2)
    assert attention.attn_chunk(1536) == 512
    out, _ = attention.attention_full(cfg, p, torch.tensor(x), torch.tensor(pos))
    plain, _ = plain_attention_full(cfg, p, torch.tensor(x), torch.tensor(pos))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    jout, _ = jattn.attention_full(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("n", (9, 512))
def test_chunked_mla_is_bit_equal_with_one_chunk(mla_layer, n):
    _, _, cfg, p = mla_layer
    x, pos = (torch.tensor(a) for a in _inputs(cfg, n, 3))
    out, (c, k) = mla.mla_full(cfg, p, x, pos)
    want, (wc, wk) = plain_mla_full(cfg, p, x, pos)
    assert torch.equal(out, want) and torch.equal(c, wc) and torch.equal(k, wk)


def test_chunked_mla_matches_unchunked_and_reference_at_1536(mla_layer):
    jcfg, jp, cfg, p = mla_layer
    x, pos = _inputs(cfg, 1536, 4)
    out, _ = mla.mla_full(cfg, p, torch.tensor(x), torch.tensor(pos))
    plain, _ = plain_mla_full(cfg, p, torch.tensor(x), torch.tensor(pos))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    jout, _ = jmla.mla_full(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jout), **TOL)


def test_chunked_attention_gradient_matches_unchunked():
    """Under a gradient each chunk is recomputed in the backward: the
    gradients of q, k and v equal the unchunked code's within 1e-5."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 1024, 4, 8, generator=g, requires_grad=True) for _ in range(3))
    pos = torch.arange(1024)[None]
    out = attention.causal_attention(q, k, v, pos)
    want = attention._attend(q, k, v, attention.causal_mask(pos, pos))
    dout = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), dout)
    exp = torch.autograd.grad(want, (q, k, v), dout)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
