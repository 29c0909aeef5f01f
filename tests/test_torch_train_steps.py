"""The port's train step against the JAX package's, on the same weights
(``params_from_numpy``) and the same numpy batches.

Two ``make_train_step`` steps (the reference's default schedule) give the
reference's losses within 1e-5 relative and updated params within 1e-5 of
each tensor's scale, plus a thousandth of the step's learning rate: an
element whose gradient is near zero gets an Adam update of its own sign
and magnitude over its own (noisy) size, whatever the scale of its
tensor, and a zero-initialised tensor (biases, rwkv6's bonus) is nothing
but that update after one step.  On llama3-1b, deepseek-moe-16b (MoE with shared
experts), zamba2-2.7b, rwkv6-7b, minicpm3-4b (MLA), llama-3.2-vision-90b
(with ``enc``) and musicgen-large (``embeds`` and labels).  Step 0 runs at
learning rate 0 (the warmup's first step), so its first moment is 0.1 x
the clipped gradient, held against the reference's at 1e-4 of each
tensor's scale: the backward's parity.  The params move at step 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.api import make_model as jmake_model
from repro.optim import adamw_init as jadamw_init
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import make_model
from repro_torch.optim import adamw_init
from test_torch_model import unbox

STEP_CONFIGS = ("llama3-1b", "deepseek-moe-16b", "zamba2-2.7b", "rwkv6-7b", "minicpm3-4b",
                "llama-3.2-vision-90b", "musicgen-large")
B, S = 2, 8
LR = dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)  # the reference's defaults


def _pair(name, seed=0):
    """(JAX model, JAX params, port model, port params) of a smoke config,
    the port's weights converted from the reference's."""
    jm = jmake_model(jget_config(name, smoke=True))
    jp = jm.init(jax.random.PRNGKey(seed))
    cfg = get_config(name, smoke=True)
    return jm, jp, make_model(cfg, "cpu"), params_from_numpy(cfg, unbox(jp), "cpu")


def _batch(cfg, step, rng_seed=7):
    """A seeded numpy batch in the train step's form: tokens [B, S+1], or
    embeddings and labels for musicgen; + encoder states for vision."""
    rng = np.random.default_rng((rng_seed, step))
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks}
    if not cfg.embed_inputs:
        batch = {"embeds": (0.02 * rng.normal(size=(B, S, cfg.d_model))).astype(np.float32),
                 "labels": toks[:, 1:]}
    if cfg.n_enc_tokens:
        batch["enc"] = rng.normal(size=(B, cfg.n_enc_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _close_to_scale(got, want, rel, what, atol=0.0):
    """Every element within ``rel`` of ``want``'s largest magnitude (and
    ``rel`` relative), + ``atol``: the tolerance of a sum whose terms cancel."""
    g, w = got.detach().numpy(), want.detach().numpy()
    np.testing.assert_allclose(g, w, rtol=rel, atol=rel * np.abs(w).max() + atol, err_msg=what)


@pytest.mark.parametrize("name", STEP_CONFIGS)
def test_two_train_steps_match_reference(name):
    jm, jp, tm, tp = _pair(name)
    cfg = tm.cfg
    init = {n: p.detach().clone() for n, p in tp.named_parameters()}
    jstep = jax.jit(jmake_train_step(jm.cfg, jm, **LR))
    step = make_train_step(cfg, tm, **LR)
    jopt = jadamw_init(jp)
    tp.requires_grad_(True)
    opt = adamw_init(tp)
    for k in range(2):
        batch = _batch(cfg, k)
        jp, jopt, jloss = jstep(jp, jopt, {n: jnp.asarray(v) for n, v in batch.items()})
        tp, opt, loss = step(tp, opt, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=f"{name} {k}")
        if k == 0:  # lr 0: the params stay, the first moment is 0.1 x the clipped gradient
            jmu = params_from_numpy(cfg, unbox(jopt.mu), "cpu")
            for (pname, _), mu, jm_ in zip(tp.named_parameters(), opt.mu, jmu.parameters()):
                _close_to_scale(mu, jm_, 1e-4, f"{name} step 0 mu {pname}")
    assert opt.step == int(jopt.step) == 2
    want = params_from_numpy(cfg, unbox(jp), "cpu")
    lr1 = float(jwarmup_cosine(1, **LR))  # step 1's learning rate (step 0's is 0)
    for (pname, got), w in zip(tp.named_parameters(), want.parameters()):
        assert got.requires_grad and got.shape == w.shape, pname
        _close_to_scale(got, w, 1e-5, f"{name} {pname}", atol=1e-3 * lr1)
        assert not torch.equal(got, init[pname]), f"{name} {pname} did not move"


def test_prefill_decode_and_verify_steps_match_reference():
    """``make_prefill_step``, ``make_decode_step`` and
    ``make_spec_verify_step`` emit the reference's tokens and equal caches'
    logits on llama3-1b's smoke config."""
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps

    jm, jp, tm, tp = _pair("llama3-1b", seed=3)
    toks = _batch(tm.cfg, 0)["tokens"][:, :6]
    jtok, jcache = jsteps.make_prefill_step(jm.cfg, jm, S_max=32)(jp, {"tokens": jnp.asarray(toks)})
    tok, cache = steps.make_prefill_step(tm.cfg, tm, S_max=32)(tp, {"tokens": toks})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for _ in range(3):
        jtok, jcache = jsteps.make_decode_step(jm.cfg, jm, S_max=32)(jp, jcache, jtok)
        tok, cache = steps.make_decode_step(tm.cfg, tm, S_max=32)(tp, cache, tok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    n = 4  # a causal chain of n tree nodes after the cache's rows
    start = int(cache["len"])
    pos = np.broadcast_to(start + np.arange(n, dtype=np.int32), (B, n))
    mask = np.arange(32)[None, None, :] <= pos[:, :, None]
    nodes = _batch(tm.cfg, 1)["tokens"][:, :n]
    jout, _ = jsteps.make_spec_verify_step(jm.cfg, jm, S_max=32, bs=n)(
        jp, jcache, jnp.asarray(nodes), jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(mask))
    out, _ = steps.make_spec_verify_step(tm.cfg, tm, S_max=32, bs=n)(tp, cache, nodes, pos, pos,
                                                                      mask)
    assert out.shape == (B, n) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
