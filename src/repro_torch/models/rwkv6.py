"""RWKV-6 "Finch" block (``repro.models.rwkv6``): time-mix with a
data-dependent decay, and channel-mix.

The WKV recurrence has the reference's two forms: the chunked segment-sum
form for a prompt (no commit count, S >= 16) and the per-step form for
everything else (a short prompt, chain-mode verification and decode).  The
two compute the same function but do not round alike, so each call takes
the form the reference takes for it.

Parameters, per block: the reference's, under its key names, but for
``w_rkvg`` [4, d, d], its w_r, w_k, w_v and w_g stacked (one batched product
of the four token-shift mixes instead of four products).  State per layer:
the time-mix and channel-mix token-shift vectors [B, d] and the WKV state
[B, H, hd, hd] (float32).

Chain mode commits a count: with ``n_commit`` the returned WKV state is the
one after exactly the first ``n_commit`` steps (the input's when it is 0)
and the token-shift vectors are the inputs of step ``n_commit`` (``ext[n]``
of the shifted sequence), while the outputs are teacher-forced over all S
steps.  The reference passes a mask ``arange(S) < n_commit``.  The block
never writes its input state: it returns new state tensors, so a cache
that a caller keeps (the chain engine's snapshots) keeps its state.

Tensor parallel (``parallel/shard.py``): where the ranks divide the heads,
a rank's time-mix runs on its contiguous share of them — its columns of
``w_rkvg`` and ``decay_b``, its channels of ``decay_base`` and ``ln_x``
(per head, so the norm stays local), its rows of ``bonus_u`` and of
``w_o``, whose partial products are summed over the group — and its WKV
state holds its heads; elsewhere every rank runs the whole time-mix alone
(the reference's ``spec_for`` replicates too).  The channel-mix splits its
ff over the ranks (``cm_k`` columns, ``cm_v`` rows), and ``k @ cm_v`` is
summed before the gate: ``cm_r`` stays whole on every rank, since
sigmoid(xr @ cm_r) multiplies the whole sum (the reference's layout splits
``cm_r`` and lets GSPMD gather; the function is the same).  The
token-shift vectors are whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, project, project_batched

DECAY_LORA = 64


def _dims(cfg):
    """(heads, head width) of this rank's time-mix: its ``ssm_heads`` where
    the heads are split over a group, else all d_model // hd."""
    hd = cfg.ssm_head_dim
    return getattr(cfg, "ssm_heads", 0) or cfg.d_model // hd, hd


def init_rwkv6(cfg, gen: torch.Generator, device) -> dict:
    """Seeded weights at the reference's init scales (torch's generator, so
    other numbers than ``jax.random``)."""
    d, ff = cfg.d_model, cfg.d_ff
    H, hd = _dims(cfg)
    dt = getattr(torch, cfg.param_dtype)

    def init(shape, scale=None):
        return dense_init(gen, shape, dt, device, scale)

    def const(shape, val):
        return torch.full(shape, val, dtype=dt, device=device)

    return {
        "mu_tm": const((5, d), 0.5),  # r, k, v, g, w mixes
        "w_rkvg": torch.stack([init((d, d)) for _ in range(4)]),
        "w_o": init((d, d)),
        "decay_base": const((d,), -6.0),
        "decay_a": init((d, DECAY_LORA), 0.1),
        "decay_b": init((DECAY_LORA, d), 0.1),
        "bonus_u": const((H, hd), 0.0),
        "ln_x": const((d,), 1.0),
        "mu_cm": const((2, d), 0.5),  # k, r mixes
        "cm_k": init((d, ff)),
        "cm_v": init((ff, d)),
        "cm_r": init((d, d)),
    }


def params_from_reference(p: dict) -> dict:
    """The reference's block parameters (tensors, its key names) in this
    module's layout."""
    out = {k: v for k, v in p.items() if k not in ("w_r", "w_k", "w_v", "w_g")}
    out["w_rkvg"] = torch.stack([p["w_r"], p["w_k"], p["w_v"], p["w_g"]])
    return out


def _shifted(x, last):
    """x [B, S, d], last [B, d] or None (zeros) -> ext [B, S+1, d]: the
    previous-token tensor is ext[:, :S], and ext[:, n] the token-shift
    vector after n steps."""
    if last is None:
        last = x.new_zeros((x.shape[0], x.shape[2]))
    return torch.cat([last[:, None].to(x.dtype), x], dim=1)


def _wkv_chunked(r, k, v, logw, u, state0, chunk=32):
    """Chunked WKV-6: the segment-sum form of the recurrence, chunk by
    chunk (the reference's ``lax.scan`` over chunks).  Within a chunk with
    L = cumsum(log w) per k-channel:

      y_t = Σ_k r_t[k]·e^{L_{t-1}[k]}·S_0[k,:]                      (cross)
          + Σ_{j<t} Σ_k r_t[k]·k_j[k]·e^{L_{t-1}[k]-L_j[k]}·v_j     (intra)
          + (r_t·(u⊙k_t))·v_t                                       (bonus)
      S_C = e^{L_C} ⊙ S_0 + Σ_j e^{L_C - L_j} ⊙ k_j ⊗ v_j

    Exponents are masked before exp (all are ≤ 0 where kept).  r, k, v,
    logw [B, S, H, hd] (logw ≤ 0); u [H, hd]; state0 [B, H, hd, hd].
    Returns (y [B, S, H, hd] f32, final state f32)."""
    B, S, H, hd = r.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    nc = S // chunk
    rf, kf, vf, lw = (t.float().reshape(B, nc, chunk, H, hd) for t in (r, k, v, logw))
    Lc = torch.cumsum(lw, dim=2)  # inclusive decay log-sums
    Lprev = Lc - lw  # L_{t-1}
    idx = torch.arange(chunk, device=r.device)
    tri = (idx[:, None] > idx[None, :])[None, :, :, None, None]  # j < t
    state = state0.float()
    ys = []
    for i in range(nc):
        rc, kc, vc, lc, lp = rf[:, i], kf[:, i], vf[:, i], Lc[:, i], Lprev[:, i]
        y_cross = torch.einsum("bthk,bhkv->bthv", rc * torch.exp(lp), state)
        seg = lp[:, :, None] - lc[:, None, :]  # [B, t, j, H, hd]
        E = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
        M = (rc[:, :, None] * kc[:, None] * E).sum(-1)  # [B, t, j, H]
        y_intra = torch.einsum("btjh,bjhv->bthv", M, vc)
        y_bonus = (rc * u * kc).sum(-1, keepdim=True) * vc
        decay_end = torch.exp(lc[:, -1:] - lc)  # e^{L_C - L_j}
        state = torch.exp(lc[:, -1])[..., None] * state + torch.einsum(
            "bjhk,bjhv->bhkv", kc * decay_end, vc)
        ys.append(y_cross + y_intra + y_bonus)
    return torch.stack(ys, dim=1).reshape(B, S, H, hd), state


def _wkv_scan(r, k, v, w, u, state0, n_commit=None):
    """WKV-6 recurrence, step by step.  r, k, v [B, S, H, hd]; w [B, S, H, hd]
    decay in (0, 1); u [H, hd] bonus; state0 [B, H, hd(k), hd(v)].

      y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ);  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

    Outputs are teacher-forced over all S steps; the returned state is the
    one after the first ``n_commit`` steps (all S when None; ``state0``
    itself when 0).  Each step runs the same operations at the same shapes
    whatever S is, so a step of a chain rounds as a decode step does."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    ub = u[None, :, :, None]
    full = state0.float()
    committed = full
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # [B, H, hd, hd]
        ys.append(torch.matmul(rf[:, t, :, None, :], torch.addcmul(full, ub, kv))[:, :, 0])
        full = torch.addcmul(kv, wf[:, t, :, :, None], full)
        if n_commit is not None and t + 1 == n_commit:
            committed = full
    return torch.stack(ys, dim=1), (full if n_commit is None else committed)


def _head_norm(yh, ln_x):
    """The group-norm substitute on the WKV output yh [B, S, H, hd] (f32):
    each head's rms over its hd values, then the learned scale ``ln_x``
    [H·hd] in f32.  -> [B, S, H·hd] f32.  PyTorch's mean over a head's 64
    values gives a row the same bits alone and among rows on the card
    (``tools/bf16_invariance.py``'s reductions), so it stays plain."""
    B, S, H, hd = yh.shape
    yh = yh * torch.rsqrt((yh * yh).mean(-1, keepdim=True) + 1e-5)
    return yh.reshape(B, S, H * hd) * ln_x.float()


def rwkv6_time_mix(cfg, p, x, cache=None, n_commit=None, tp=None):
    """Time-mix on x [B, S, d] with state ``cache`` ({"sx_tm", "wkv"}, or
    None: zeros).  tp: the group this rank's heads are split over (None:
    all heads here); ``x`` then enters the rank's heads through
    ``TPGroup.copy`` (the gradients of the whole ``mu_tm`` and ``decay_a``,
    which only the rank's heads read, are summed by
    ``parallel.shard.Shard.reduce_grads``).  ``tp`` may be a
    ``parallel.SeqGroup`` (the residual stream sequence-sharded): ``x`` is
    then this rank's rows, and the token shift runs on the whole sequence
    its ``copy`` gathers.  Returns (out [B, S, d], {"sx_tm", "wkv"})."""
    if tp is not None:
        x = tp.copy(x)
    B, S, d = x.shape
    H, hd = _dims(cfg)
    ext = _shifted(x, None if cache is None else cache["sx_tm"])
    prev = ext[:, :S]
    mix = x + (prev - x) * p["mu_tm"][:, None, None, :]  # [5, B, S, d]: r, k, v, g, w
    rkvg = project_batched(mix[:4].reshape(4, B * S, d), p["w_rkvg"]).reshape(4, B, S, H, hd)
    r, k, v = rkvg[0], rkvg[1], rkvg[2]
    g = F.silu(rkvg[3].reshape(B, S, H * hd))
    # data-dependent decay (the Finch feature): w = exp(-exp(base + lora(x)))
    dec = p["decay_base"].float() + project(torch.tanh(project(mix[4], p["decay_a"])),
                                            p["decay_b"]).float()
    logw = -torch.exp(dec).reshape(B, S, H, hd)  # log-decay, always <= 0
    state0 = (cache["wkv"] if cache is not None else
              x.new_zeros((B, H, hd, hd), dtype=torch.float32))
    u = p["bonus_u"].float()
    if n_commit is None and S >= 16:
        y, state = _wkv_chunked(r, k, v, logw, u, state0)
    else:
        y, state = _wkv_scan(r, k, v, torch.exp(logw), u, state0,
                             None if n_commit is None else int(n_commit))
    y = _head_norm(y.to(x.dtype).float(), p["ln_x"]).to(x.dtype)
    out = project(y * g, p["w_o"])
    if tp is not None:
        out = tp.reduce(out)
    return out, {"sx_tm": ext[:, S if n_commit is None else int(n_commit)], "wkv": state}


def rwkv6_channel_mix(cfg, p, x, cache=None, n_commit=None, tp=None, seq=None):
    """Channel-mix on x [B, S, d] with state ``cache`` ({"sx_cm"}, or None).
    tp: the group the ff is split over (None: whole here); ``xk`` enters
    the rank's ``cm_k`` columns through ``TPGroup.copy`` and ``k @ cm_v`` is
    summed over it before the gate, which the whole ``cm_r`` computes on
    every rank.

    seq: a ``parallel.SeqGroup`` over ``tp`` (the residual stream
    sequence-sharded; ``x`` this rank's rows): the token shift reads the
    row before, another rank's at a shard's edge, so ``x`` enters by
    ``seq.copy`` (the whole sequence) before it; ``k @ cm_v`` is
    reduce-scattered to the rank's rows and gated there by ``cm_r`` on the
    rank's rows of ``xr``, which are rank-local work: the gradients of
    ``mu_cm`` and ``cm_r`` are then partial, summed by
    ``parallel.shard.Shard.reduce_grads``.  Returns (out [B, S, d],
    {"sx_cm"})."""
    if seq is not None:
        x = seq.copy(x)
    S = x.shape[1]
    ext = _shifted(x, None if cache is None else cache["sx_cm"])
    prev = ext[:, :S]
    mu = p["mu_cm"]
    xk = x + (prev - x) * mu[0]
    xr = x + (prev - x) * mu[1]
    if tp is not None and seq is None:
        xk = tp.copy(xk)
    k = torch.square(F.relu(project(xk, p["cm_k"])))
    kv = project(k, p["cm_v"])
    if seq is not None:
        out = torch.sigmoid(project(seq.rows_of(xr), p["cm_r"])) * seq.reduce(kv)
    else:
        out = torch.sigmoid(project(xr, p["cm_r"])) * (kv if tp is None else tp.reduce(kv))
    return out, {"sx_cm": ext[:, S if n_commit is None else int(n_commit)]}


def init_rwkv_cache(cfg, B, dtype, device):
    H, hd = _dims(cfg)
    return {
        "sx_tm": torch.zeros((B, cfg.d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((B, H, hd, hd), dtype=torch.float32, device=device),
        "sx_cm": torch.zeros((B, cfg.d_model), dtype=dtype, device=device),
    }
