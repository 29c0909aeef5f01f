"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the JAX package's, at the minicpm3-4b smoke config, on the same
weights and inputs (atol = rtol = 1e-4, float32).

``mla_full`` (prefill: causal, per-head K/V built from the latent) and
``mla_cached`` (the absorbed form) in both of its write paths: rows at
``row_idx`` under a tree mask — rows out of order, one skipped (-1), one
query that sees no row and must give 0 — and contiguous rows from
``row_start`` (decode / chain).  The latent caches ``ckv`` and ``krope``
must equal the reference's after each write.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from repro.configs import get_config as jget_config
from repro.models import mla as jmla
from repro_torch.configs import ModelConfig
from repro_torch.models import mla
from test_torch_model import unbox

TOL = dict(atol=1e-4, rtol=1e-4)
B, P, S = 2, 8, 24


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("minicpm3-4b", smoke=True)
    jp = jmla.init_mla(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    for name in ("q_norm", "kv_norm"):  # norms away from one, so they are not multiplications by 1
        jp[name].value = jnp.asarray(1 + 0.1 * rng.normal(size=jp[name].value.shape), jnp.float32)
    p = {k: torch.tensor(v) for k, v in unbox(jp).items()}
    return jcfg, jp, ModelConfig(**dataclasses.asdict(jcfg)), p


def _x(cfg, n, seed):
    return np.random.default_rng(seed).normal(size=(B, n, cfg.d_model)).astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)


def _prefilled(jcfg, jp, cfg, p):
    """Both sides' latent caches [B, S, ...] after a prefill of P rows."""
    x = _x(cfg, P, 1)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P))
    _, (jc, jk) = jmla.mla_full(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    _, (c, k) = mla.mla_full(cfg, p, torch.tensor(x), torch.tensor(pos))
    pad = ((0, 0), (0, S - P), (0, 0))
    ckv, krope = torch.zeros(B, S, cfg.kv_lora_rank), torch.zeros(B, S, cfg.rope_head_dim)
    ckv[:, :P], krope[:, :P] = c, k
    return (jnp.pad(jc, pad), jnp.pad(jk, pad)), (ckv, krope)


def test_mla_full_matches_reference(setup):
    jcfg, jp, cfg, p = setup
    x = _x(cfg, P, 1)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P))
    jout, (jc, jk) = jmla.mla_full(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    out, (c, k) = mla.mla_full(cfg, p, torch.tensor(x), torch.tensor(pos))
    _close(out, jout, "mla_full out")
    _close(c, jc, "mla_full c_kv")
    _close(k, jk, "mla_full k_rope")


def test_mla_cached_tree_rows_match_reference(setup):
    """Rows out of order, a skipped entry, ancestor subsets, and a query
    that sees nothing (its output must be exactly 0 before the output
    projection, so the block adds nothing)."""
    jcfg, jp, cfg, p = setup
    (jc, jk), (ckv, krope) = _prefilled(jcfg, jp, cfg, p)
    n = 5
    rows = np.array([[P - 1, P, -1, P + 2, P + 1], [P - 1, P + 1, P, P + 3, -1]], np.int32)
    pos = np.array([[P - 1, P, P, P + 1, P + 2]] * B, np.int32)
    rng = np.random.default_rng(2)
    mask = np.zeros((B, n, S), bool)
    mask[:, :, :P - 1] = True
    for b in range(B):
        for i in range(n):
            if rows[b, i] >= 0:
                mask[b, i, rows[b, i]] = True
                prev = rows[b, :i][rows[b, :i] >= 0]
                mask[b, i, prev] = rng.random(len(prev)) < 0.6
    mask[1, 4] = False
    x = _x(cfg, n, 3)
    jout, jc2, jk2 = jmla.mla_cached(jcfg, jp, jnp.asarray(x), jc, jk, jnp.asarray(rows),
                                     jnp.asarray(pos), jnp.asarray(mask))
    out, c2, k2 = mla.mla_cached(cfg, p, torch.tensor(x), ckv, krope, torch.tensor(rows),
                                 torch.tensor(pos), torch.tensor(mask))
    assert c2 is ckv and k2 is krope, "the latent rows are written in place"
    _close(out, jout, "mla_cached out")
    _close(c2, jc2, "mla_cached ckv")
    _close(k2, jk2, "mla_cached krope")
    assert torch.all(out[1, 4] == 0), "a query that sees no row must give 0"


def test_mla_cached_row_start_matches_reference(setup):
    """The decode / chain path: n contiguous rows from row_start, causal."""
    jcfg, jp, cfg, p = setup
    (jc, jk), (ckv, krope) = _prefilled(jcfg, jp, cfg, p)
    for step, n in enumerate((1, 3)):
        start = P + 4 * step
        pos = np.broadcast_to(np.arange(start, start + n, dtype=np.int32), (B, n))
        mask = np.arange(S)[None, None, :] <= pos[:, :, None]
        x = _x(cfg, n, 4 + step)
        jout, jc, jk = jmla.mla_cached(jcfg, jp, jnp.asarray(x), jc, jk, jnp.asarray(pos),
                                       jnp.asarray(pos), jnp.asarray(mask), row_start=start)
        out, ckv, krope = mla.mla_cached(cfg, p, torch.tensor(x), ckv, krope, torch.tensor(pos),
                                         torch.tensor(pos), torch.tensor(mask), row_start=start)
        _close(out, jout, f"mla_cached row_start {start} out")
        _close(ckv, jc, f"mla_cached row_start {start} ckv")
        _close(krope, jk, f"mla_cached row_start {start} krope")
