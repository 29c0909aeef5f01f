"""MLA's absorbed attention through ``ops.latent_attention`` and the
per-head batched products, on the CPU, against the JAX package's MLA at
the minicpm3-4b smoke config.

* The plain version (``ref.latent_attention_ref``, the einsum composite the
  port ran before the kernel) against the reference's absorbed attention as
  ``mla_cached`` computes it (f32 2e-5, bf16 2e-2), a query that sees no
  row exactly 0; the wrapper's meta branch counts the operations of those
  einsums, and its bytes by ``kernels/work.py``; it refuses bad shapes.
* ``mla_cached`` in bf16 against the reference's (its serving products, the
  kernel's plain version, W_uk and W_uv head by head) within 2e-2.
* The cache-filling prefill attends absorbed through the same wrapper
  (``mla_prefill``), in chunks of ``ATTN_CHUNK`` queries: its output and
  latents within 1e-4 (f32) of the reference's ``mla_full``, the chunked
  result within 1e-5 of one chunk, one call a chunk; a training forward
  takes ``mla_full`` and never calls the wrapper.  In bf16 the first
  verify recomputes the prompt's last row with the prefill's bits.
* ``mla.head_major``: one copy per weight, made again after the weight is
  written in place, dropped with the weight.
"""

import dataclasses
import gc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.models import mla as jmla
from repro.models.api import make_model as jmake_model
from repro_torch.configs import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref, work
from repro_torch.launch import cost
from repro_torch.models import mla
from repro_torch.models.api import make_model
from test_torch_model import unbox

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
B, S = 2, 24


def _draw(rng, shape, dtype, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32).to(dtype)


def _reference_absorbed(q_lat, q_rope, ckv, krope, mask, scale):
    """The reference's absorbed attention, src/repro/models/mla.py:116-125."""
    scores = (jnp.einsum("bnhl,bsl->bhns", q_lat, ckv)
              + jnp.einsum("bnhk,bsk->bhns", q_rope, krope)) * scale
    scores = jnp.where(mask[:, None, :, :], scores.astype(jnp.float32), -1e30)
    probs = jax.nn.softmax(scores, axis=-1)
    probs = jnp.where(jnp.any(mask[:, None, :, :], axis=-1, keepdims=True), probs, 0.0)
    return jnp.einsum("bhns,bsl->bnhl", probs.astype(ckv.dtype), ckv)


def _inputs(dtype, n=5, H=4, KL=16, RD=8, seed=0):
    rng = np.random.default_rng(seed)
    q_lat, q_rope = _draw(rng, (B, n, H, KL), dtype, KL ** -0.5), _draw(rng, (B, n, H, RD), dtype)
    ckv, krope = _draw(rng, (B, S, KL), dtype), _draw(rng, (B, S, RD), dtype)
    mask = torch.tensor(rng.random((B, n, S)) < 0.4)
    mask[0, 1] = False  # a query that sees no row
    mask[1, :, S - 1] = True
    return q_lat, q_rope, ckv, krope, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_version_matches_the_reference_absorbed_attention(dtype):
    q_lat, q_rope, ckv, krope, mask = _inputs(dtype)
    scale = 1 / math.sqrt(24)
    got = ops.latent_attention(q_lat, q_rope, ckv, krope, mask, scale)
    assert got.dtype == dtype and got.shape == q_lat.shape
    assert torch.equal(got, ref.latent_attention_ref(q_lat, q_rope, ckv, krope, mask, scale))
    assert torch.equal(got[0, 1], torch.zeros_like(got[0, 1]))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _reference_absorbed(*(jnp.asarray(t.float().numpy()).astype(jdt)
                                 for t in (q_lat, q_rope, ckv, krope)),
                               jnp.asarray(mask.numpy()), scale)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_meta_branch_counts_the_einsums_operations(dtype):
    q_lat, q_rope, ckv, krope, mask = (t.to("meta") for t in _inputs(dtype, n=8, H=40, KL=256,
                                                                       RD=32))
    out = ops.latent_attention(q_lat, q_rope, ckv, krope, mask, 0.1)
    assert out.shape == q_lat.shape and out.dtype == dtype and out.device.type == "meta"
    with torch.no_grad():
        plain, _ = cost.count(ref.latent_attention_ref, q_lat, q_rope, ckv, krope, mask, 0.1)
        ours, _ = cost.count(ops.latent_attention, q_lat, q_rope, ckv, krope, mask, 0.1)
    assert ours.flops == plain.flops
    assert ours.calls == {"latent_attention": 1}
    flops, nbytes = work.latent_attention(q_lat, q_rope, ckv, krope, mask, 0.1)
    assert (ours.flops["forward"], ours.bytes["forward"]) == (flops, nbytes)
    es = q_lat.element_size()
    assert nbytes == (2 * q_lat.numel() + q_rope.numel() + B * S * (256 + 32)) * es + mask.numel()


def test_the_wrapper_refuses_bad_shapes():
    q_lat, q_rope, ckv, krope, mask = _inputs(torch.float32)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.latent_attention(q_lat, q_rope, ckv, krope, mask[:, :2], 0.1)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.latent_attention(q_lat, q_rope[..., :4], ckv, krope, mask, 0.1)


@pytest.fixture(scope="module")
def setup():
    """The reference's MLA block parameters at the minicpm3-4b smoke config
    (norms away from one) and the port's, f32 and bf16."""
    jcfg = jget_config("minicpm3-4b", smoke=True)
    jp = jmla.init_mla(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    for name in ("q_norm", "kv_norm"):
        jp[name].value = jnp.asarray(1 + 0.1 * rng.normal(size=jp[name].value.shape), jnp.float32)
    return jcfg, jp, ModelConfig(**dataclasses.asdict(jcfg)), unbox(jp)


def _x(cfg, n, seed):
    return np.random.default_rng(seed).normal(size=(B, n, cfg.d_model)).astype(np.float32)


def test_mla_cached_in_bf16_matches_the_reference(setup):
    jcfg, jp, cfg, tree = setup
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16", param_dtype="bfloat16")
                 for c in (jcfg, cfg))
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    p = {k: torch.tensor(v, dtype=torch.float32).to(torch.bfloat16) for k, v in tree.items()}
    rng = np.random.default_rng(3)
    P, n = 8, 4
    ckv0 = rng.normal(size=(B, S, cfg.kv_lora_rank)).astype(np.float32)
    kr0 = rng.normal(size=(B, S, cfg.rope_head_dim)).astype(np.float32)
    x = _x(cfg, n, 4)
    pos = np.broadcast_to(np.arange(P, P + n, dtype=np.int32), (B, n))
    mask = np.zeros((B, n, S), bool)
    mask[:, :, :P] = True
    mask[:, np.arange(n), P + np.arange(n)] = True
    mask[1, 2] = False  # a query that sees no row
    jout, _, _ = jmla.mla_cached(jcfg, jpb, jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(ckv0, jnp.bfloat16), jnp.asarray(kr0, jnp.bfloat16),
                                 None, jnp.asarray(pos), jnp.asarray(mask), row_start=P)
    with torch.no_grad():
        out, _, _ = mla.mla_cached(cfg, p, torch.tensor(x).to(torch.bfloat16),
                                   torch.tensor(ckv0).to(torch.bfloat16),
                                   torch.tensor(kr0).to(torch.bfloat16), None, torch.tensor(pos),
                                   torch.tensor(mask), row_start=P)
    want = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_the_prefill_attends_absorbed_within_the_reference_mla_full(setup):
    jcfg, jp, cfg, tree = setup
    p = {k: torch.tensor(v) for k, v in tree.items()}
    n = 10
    x = _x(cfg, n, 1)
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (B, n))
    jout, (jc, jk) = jmla.mla_full(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    ckv = torch.zeros(B, S, cfg.kv_lora_rank)
    krope = torch.zeros(B, S, cfg.rope_head_dim)
    with torch.no_grad():
        out, (c, k) = mla.mla_prefill(cfg, p, torch.tensor(x), torch.tensor(pos), (ckv, krope))
    for got, want, what in ((out, jout, "out"), (c, jc, "c_kv"), (k, jk, "k_rope"),
                            (ckv[:, :n], jc, "the cache's latents")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4,
                                   err_msg=what)
    assert not ckv[:, n:].any()


def test_the_prefill_attends_in_chunks_one_call_each(setup, monkeypatch):
    _, _, cfg, tree = setup
    p = {k: torch.tensor(v) for k, v in tree.items()}
    n = 10
    x, pos = torch.tensor(_x(cfg, n, 2)), torch.arange(n, dtype=torch.int32).expand(B, n)
    with torch.no_grad():
        whole, _ = mla.mla_prefill(cfg, p, x, pos)
        calls = []
        real = ops.latent_attention

        def spy(q_lat, q_rope, ckv, krope, mask, scale):
            calls.append((q_lat.shape[1], ckv.shape[1]))
            return real(q_lat, q_rope, ckv, krope, mask, scale)

        monkeypatch.setattr(ops, "latent_attention", spy)
        monkeypatch.setattr(mla, "ATTN_CHUNK", 4)
        chunked, _ = mla.mla_prefill(cfg, p, x, pos)
    assert calls == [(4, n), (4, n), (2, n)]
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-5, rtol=1e-5)


def test_a_training_forward_takes_mla_full(monkeypatch):
    model = make_model(get_smoke("minicpm3-4b"), "cpu")
    params = model.init(0, trainable=True)
    calls = {"kernel": 0, "full": 0}
    real_kernel, real_full = ops.latent_attention, mla.mla_full

    def kernel(*a):
        calls["kernel"] += 1
        return real_kernel(*a)

    def full(*a, **k):
        calls["full"] += 1
        return real_full(*a, **k)

    monkeypatch.setattr(ops, "latent_attention", kernel)
    monkeypatch.setattr(mla, "mla_full", full)
    tokens = torch.tensor(np.random.default_rng(6).integers(0, 256, size=(2, 8)), dtype=torch.int32)
    model.forward_train(params, tokens).float().square().mean().backward()
    assert calls == {"kernel": 0, "full": model.cfg.n_layers}
    with torch.no_grad():
        model.prefill(model.init(0), tokens, S_max=16)
    assert calls["kernel"] == model.cfg.n_layers


def get_smoke(name):
    from repro_torch.configs import get_config

    return get_config(name, smoke=True)


def test_a_verify_recomputes_the_prompts_last_row_as_the_prefill_did():
    """bf16: the first verify's root is the prompt's last token, which the
    prefill already wrote; its logits and latents must be the prefill's
    bits, or the engine and the greedy decode start from other caches."""
    jm = jmake_model(dataclasses.replace(jget_config("minicpm3-4b", smoke=True),
                                         dtype="bfloat16", param_dtype="bfloat16"))
    jp = jm.init(jax.random.PRNGKey(7))
    cfg = ModelConfig(**dataclasses.asdict(jm.cfg))
    T, tp = make_model(cfg, "cpu"), params_from_numpy(cfg, unbox(jp), "cpu")
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(1, 8)).astype(np.int32)
    with torch.no_grad():
        lg, cache = T.prefill(tp, prompt, S_max=32)
        before = [{k: v.clone() for k, v in blk.items()} for blk in cache["groups"][0]]
        pos = np.array([[7, 8, 8]], np.int32)
        mask = np.zeros((1, 3, 32), bool)
        mask[0, :, :8] = True
        mask[0, 1:, 8:10] = np.eye(2, dtype=bool)
        vl, cache = T.spec_forward(tp, cache, np.array([[int(prompt[0, -1]), 5, 6]], np.int32),
                                   pos, np.array([[7, 8, 9]], np.int32), mask)
    assert torch.equal(vl[0, 0], lg[0, -1])
    for blk, old in zip(cache["groups"][0], before):
        for key in ("ckv", "krope"):
            assert torch.equal(blk[key][:, :, :8], old[key][:, :, :8])


def test_the_head_major_copy_is_made_once_per_weight():
    w = torch.nn.Parameter(torch.randn(16, 4, 8), requires_grad=False)
    with torch.no_grad():
        a = mla.head_major(w, (1, 2, 0))
        assert a.shape == (4, 8, 16) and a.is_contiguous()
        assert torch.equal(a, w.permute(1, 2, 0))
        assert mla.head_major(w, (1, 2, 0)) is a
        w.mul_(2.0)  # written in place: its version moved
        b = mla.head_major(w, (1, 2, 0))
        assert b is not a and torch.equal(b, w.permute(1, 2, 0))
    key = id(w)
    assert key in mla._HEAD_MAJOR
    del w, a, b
    gc.collect()
    assert key not in mla._HEAD_MAJOR
