"""The port's training forward and loss against the JAX package's.

``Model.forward_train`` gives the reference's logits on all 15 smoke
configs, on the same weights (``params_from_numpy``) and inputs, at the
port's prefill tolerance (atol = rtol = 1e-4 in f32).  The loss is the
reference's ``cross_entropy_loss``.  ``fused_swiglu``'s backward
(``ops.swiglu_backward``, the CUDA path's autograd) equals autograd through
the plain version on the same inputs; on the CPU the wrapper is the plain
version and differentiates through it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.models.common import cross_entropy_loss as jcross_entropy_loss
from repro_torch.configs import PORTED
from repro_torch.kernels import ops, ref
from repro_torch.models.common import cross_entropy_loss
from test_torch_train_steps import B, S, _batch, _pair

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", PORTED)
def test_forward_train_matches_reference(name):
    jm, jp, tm, tp = _pair(name)
    cfg = tm.cfg
    batch = _batch(cfg, 0)
    kw = {k: batch[k] for k in ("embeds", "enc") if k in batch}
    if "tokens" in batch:
        kw["tokens"] = batch["tokens"][:, :-1]
    want = jax.jit(jm.forward_train)(jp, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tm.forward_train(tp, **kw)
    assert got.shape == (B, S, cfg.vocab_size) and got.grad_fn is None  # frozen weights
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)


@pytest.mark.parametrize("masked", [None, "some", "none"])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = None
    if masked:
        mask = (rng.random((3, 7)) < 0.5).astype(np.float32) * (masked == "some")
    got = cross_entropy_loss(torch.tensor(logits), torch.tensor(labels),
                             None if mask is None else torch.tensor(mask))
    want = jcross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if masked == "none":  # an all-zero mask: the floor of 1 in the denominator
        assert float(got) == 0.0
    bf = cross_entropy_loss(torch.tensor(logits).to(torch.bfloat16), torch.tensor(labels))
    assert bf.dtype == torch.float32  # the log-sum-exp runs in f32


@pytest.mark.parametrize("dtype,M,K,N", [(torch.float32, 1, 64, 96), (torch.float32, 37, 128, 64),
                                         (torch.bfloat16, 16, 64, 128)])
def test_swiglu_backward_matches_autograd_of_the_plain_version(dtype, M, K, N):
    gen = torch.Generator().manual_seed(M)
    x = torch.randn((M, K), generator=gen).to(dtype)
    wg = (torch.randn((K, N), generator=gen) * K ** -0.5).to(dtype)
    wu = (torch.randn((K, N), generator=gen) * K ** -0.5).to(dtype)
    dh = torch.randn((M, N), generator=gen).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, wg, wu)]
    out = ref.fused_swiglu_ref(*leaves)
    want = torch.autograd.grad(out, leaves, dh)
    got = ops.swiglu_backward(x, wg, wu, dh)
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    for g, w, what in zip(got, want, ("dx", "dwg", "dwu")):
        assert g.dtype == w.dtype == dtype, what
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=what)


def test_fused_swiglu_differentiates_on_the_cpu():
    gen = torch.Generator().manual_seed(0)
    x, wg, wu = (torch.randn(s, generator=gen, requires_grad=True)
                 for s in ((4, 8), (8, 12), (8, 12)))
    out = ops.fused_swiglu(x, wg, wu)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out.sum(), (x, wg, wu))
    want = ops.swiglu_backward(x.detach(), wg.detach(), wu.detach(), torch.ones(4, 12))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        assert ops.fused_swiglu(x, wg, wu).grad_fn is None
