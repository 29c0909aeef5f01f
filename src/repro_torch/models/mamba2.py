"""Mamba2 (SSD) block (``repro.models.mamba2``): the chunked state-space
scan for prefill, the per-step recurrence with a committed prefix for
chain-mode verification and decode.

The chunked and the stepwise scan compute the same function but do not
round alike, so each path keeps the reference's variant: prefill (no
commit count) is chunked, every cached forward of the chain engine and
``decode_step`` is stepwise.

Parameters, per block: ``w_in`` [d, d_in | d_in | 2GN | H] is the
reference's four projections w_z, w_x, w_bc, w_dt side by side (one product
instead of four: the x and BC columns are then the conv input as they
stand), ``conv_w`` [K, conv_dim] its conv_wx and conv_wbc side by side, and
``a_log``, from which every call takes a = -exp(a_log) in float32, as the
reference does (so a trainer updates a_log, as the reference's).  Joined
products train as the reference's separate ones: AdamW is elementwise.
State per layer: the conv window [B, K-1, conv_dim] and the SSM state
[B, H, hd, N] (float32).

The block never writes its input state: it returns new state tensors, so a
cache that a caller keeps (the chain engine's pre-round snapshot) keeps its
state whatever forwards run from it.

Tensor parallel (``parallel/shard.py``), as the reference's rules split
"inner" over "model": a rank keeps the z, x and dt columns and the conv
channels of its contiguous share of the heads, all of the BC columns and
channels (the heads of the one group read them), its rows of ``out_proj``
and its heads' ``a_log``/``dt_bias``/``d_skip``/``norm_w``; its config's
``ssm_heads`` is its head count, from which every width here follows, and
its conv window and SSM state hold its x channels with all BC channels and
its heads.  The gated RMSNorm normalises over the whole d_in: each rank
sums the squares of its channels, one all-reduce per layer adds them, and
the mean divides by the global d_in (a local mean would be silently
wrong); ``out_proj``'s partial products are then summed by a second.
Where the ranks do not divide the heads, every rank holds the whole block
and runs it alone (the reference's ``spec_for`` replicates too).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, project, rms_norm


def _dims(cfg):
    """(d_in, heads, conv_dim) of this rank: its ``ssm_heads`` where the
    heads are split over a group, else the whole block's."""
    nheads = getattr(cfg, "ssm_heads", 0) or cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    d_in = nheads * cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_in, nheads, conv_dim


def segments(cfg) -> dict:
    """The widths of the segments that ``w_in``, ``conv_w`` and ``conv_b``
    join along their last dimension (``models.axes``), of the whole block:
    z | x | BC | dt and x | BC."""
    d_in, nheads, _ = _dims(cfg)
    GN2 = 2 * cfg.ssm_groups * cfg.ssm_state
    return {"w_in": (d_in, d_in, GN2, nheads), "conv_w": (d_in, GN2), "conv_b": (d_in, GN2)}


def init_mamba2(cfg, gen: torch.Generator, device) -> dict:
    """Seeded weights at the reference's init scales (torch's generator, so
    other numbers than ``jax.random``)."""
    d = cfg.d_model
    d_in, nheads, conv_dim = _dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    GN2 = 2 * cfg.ssm_groups * cfg.ssm_state

    def init(shape, scale=None):
        return dense_init(gen, shape, dt, device, scale)

    w_in = torch.cat([init((d, d_in)), init((d, d_in)), init((d, GN2)), init((d, nheads))], -1)
    conv_w = torch.cat([init((cfg.ssm_conv, d_in), 0.5), init((cfg.ssm_conv, GN2), 0.5)], -1)
    a_log = torch.log(torch.linspace(1.0, 16.0, nheads, dtype=torch.float32, device=device))
    return {
        "w_in": w_in, "conv_w": conv_w,
        "conv_b": torch.zeros(conv_dim, dtype=dt, device=device),
        "a_log": a_log.to(dt),
        "dt_bias": torch.zeros(nheads, dtype=dt, device=device),
        "d_skip": torch.ones(nheads, dtype=dt, device=device),
        "norm_w": torch.ones(d_in, dtype=dt, device=device),
        "out_proj": init((d_in, d)),
    }


def params_from_reference(p: dict) -> dict:
    """The reference's block parameters (tensors, its key names) in this
    module's layout."""
    return {
        "w_in": torch.cat([p["w_z"], p["w_x"], p["w_bc"], p["w_dt"]], -1),
        "conv_w": torch.cat([p["conv_wx"], p["conv_wbc"]], -1),
        "conv_b": p["conv_b"],
        "a_log": p["a_log"],
        "dt_bias": p["dt_bias"], "d_skip": p["d_skip"], "norm_w": p["norm_w"],
        "out_proj": p["out_proj"],
    }


def _causal_conv(x, w, b, window0=None):
    """Depthwise causal conv.  x [B, S, C], w [K, C], window0 [B, K-1, C]
    history (zeros when None).  Returns (silu(conv + b), ext [B, K-1+S, C])."""
    B, S, C = x.shape
    K = w.shape[0]
    if window0 is None:
        window0 = x.new_zeros((B, K - 1, C))
    ext = torch.cat([window0.to(x.dtype), x], dim=1)
    out = ext[:, :S] * w[0]
    for i in range(1, K):
        out = torch.addcmul(out, ext[:, i:i + S], w[i])
    return F.silu(out + b), ext


def _heads(t, rep):
    """[B, S, G, N] groups over H = G * rep heads: a broadcast view when G
    is 1, else each group repeated for its heads."""
    return t if t.shape[2] == 1 else t.repeat_interleave(rep, dim=2)


def _ssd_chunked(x, b, c, dt, a, d_skip, state0, chunk=64):
    """Chunked SSD scan.  x [B, S, H, hd]; b, c [B, S, G, N]; dt [B, S, H]
    (post-softplus, f32); a [H] f32.  Returns (y [B, S, H, hd], final state
    [B, H, hd, N] f32)."""
    B, S, H, hd = x.shape
    G = b.shape[2]
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    nc = S // chunk
    rep = H // G
    xr = x.reshape(B, nc, chunk, H, hd).float()
    br = _heads(b, rep).float()
    cr = _heads(c, rep).float()
    br = br.expand(B, S, H, br.shape[-1]).reshape(B, nc, chunk, H, -1)
    cr = cr.expand(B, S, H, cr.shape[-1]).reshape(B, nc, chunk, H, -1)
    dtr = dt.reshape(B, nc, chunk, H)
    cum = torch.cumsum(dtr * a, dim=2)  # inclusive cumsum of log-decays
    idx = torch.arange(chunk, device=x.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]
    state = state0.float()
    ys = []
    for i in range(nc):
        xc, bc, cc, dtc, cumc = xr[:, i], br[:, i], cr[:, i], dtr[:, i], cum[:, i]
        seg = cumc[:, :, None, :] - cumc[:, None, :, :]  # [B, i, j, H]
        # mask before exp: the j > i half has positive exponents that overflow
        L = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
        cb = torch.einsum("bihn,bjhn->bijh", cc, bc)
        w = cb * L * dtc[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhd->bihd", w, xc)
        y_cross = torch.einsum("bihn,bhdn->bihd", cc, state) * torch.exp(cumc)[..., None]
        decay_to_end = torch.exp(cumc[:, -1:, :] - cumc)  # [B, chunk, H]
        xw = xc * (dtc * decay_to_end)[..., None]
        state = torch.exp(cumc[:, -1, :])[:, :, None, None] * state + torch.einsum(
            "bjhd,bjhn->bhdn", xw, bc)
        ys.append((y_intra + y_cross).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(B, S, H, hd)
    return y + x * d_skip.to(x.dtype)[None, None, :, None], state


def _ssd_stepwise(x, b, c, dt, a, d_skip, state0, n_commit: int):
    """Per-step SSD recurrence for chain mode (S = chain length, small):
    the same math as the chunked scan, outputs teacher-forced over all S
    steps, and the returned state the one after the first ``n_commit``
    steps (``state0`` itself when it is 0).  Each step runs the same
    operations at the same shapes whatever S is."""
    B, S, H, hd = x.shape
    G = b.shape[2]
    rep = H // G
    xdt = x.float() * dt[..., None]  # [B, S, H, hd]
    decay = torch.exp(dt * a)  # [B, S, H]
    br = _heads(b, rep).float()  # [B, S, H or 1, N]
    cr = _heads(c, rep).float()
    full = state0.float()
    committed = full
    ys = []
    for t in range(S):
        full = torch.addcmul(full * decay[:, t, :, None, None], xdt[:, t, :, :, None],
                             br[:, t, :, None, :])
        ys.append(torch.matmul(full, cr[:, t, :, :, None])[..., 0])  # [B, H, hd]
        if t + 1 == n_commit:
            committed = full
    y = torch.stack(ys, dim=1).to(x.dtype)
    return torch.addcmul(y, x, d_skip.to(x.dtype)[None, None, :, None]), committed


def mamba2_apply(cfg, p, xin, cache=None, n_commit=None, tp=None):
    """Mamba2 block on xin [B, S, d] (a prompt, a decode step or a chain).

    cache: {"conv": [B, K-1, conv_dim], "ssm": [B, H, hd, N]} or None
    (fresh).  n_commit: None for the chunked scan whose state covers all S
    steps (prefill); an int for chain mode — the stepwise scan, with the
    returned state and conv window those after exactly the first n_commit
    steps, the outputs still teacher-forced over all S.  The reference
    passes a mask ``arange(S) < n_commit`` for every batch row; the port
    passes the count, so the commit is an index, not a select per step.
    tp: the group this rank's heads are split over (None: the whole block
    is here); the gated norm's sum of squares and ``out_proj``'s product
    are then summed over it, and ``xin`` enters the rank's heads through
    ``TPGroup.copy`` (the gradients of ``w_in``'s, ``conv_w``'s and
    ``conv_b``'s whole BC segments, which only the rank's heads read, are
    summed by ``parallel.shard.Shard.reduce_grads``).  ``tp`` may be a
    ``parallel.SeqGroup`` (the residual stream sequence-sharded): ``xin``
    is then this rank's rows, its ``copy`` gathers the whole sequence and
    its ``reduce`` scatters ``out`` back to the rows.  Returns (out [B, S,
    d], new cache); the input cache is never written."""
    if tp is not None:
        xin = tp.copy(xin)
    B, S, _ = xin.shape
    d_in, nheads, conv_dim = _dims(cfg)
    GN = cfg.ssm_groups * cfg.ssm_state
    K = cfg.ssm_conv
    proj = project(xin, p["w_in"])  # [B, S, d_in | conv_dim | H]
    z = proj[..., :d_in]
    conv, ext = _causal_conv(proj[..., d_in:d_in + conv_dim], p["conv_w"], p["conv_b"],
                             None if cache is None else cache["conv"])
    start = S if n_commit is None else int(n_commit)
    new_conv = ext[:, start:start + K - 1]  # ext holds K-1+S rows

    xc = conv[..., :d_in].reshape(B, S, nheads, cfg.ssm_head_dim)
    bv = conv[..., d_in:d_in + GN].reshape(B, S, cfg.ssm_groups, cfg.ssm_state)
    cv = conv[..., d_in + GN:].reshape(B, S, cfg.ssm_groups, cfg.ssm_state)
    dt = F.softplus(proj[..., d_in + conv_dim:].float() + p["dt_bias"].float())
    state0 = (cache["ssm"] if cache is not None else
              xin.new_zeros((B, nheads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32))
    a = -torch.exp(p["a_log"].float())  # [H]
    if n_commit is None:
        y, state = _ssd_chunked(xc, bv, cv, dt, a, p["d_skip"], state0)
    else:
        y, state = _ssd_stepwise(xc, bv, cv, dt, a, p["d_skip"], state0, int(n_commit))
    y = y.reshape(B, S, d_in) * F.silu(z)
    if tp is None:
        y = rms_norm(y, p["norm_w"], cfg.norm_eps)
        return project(y, p["out_proj"]), {"conv": new_conv, "ssm": state}
    y32 = y.float()  # rms_norm over the whole d_in: the squares summed over the ranks
    var = tp.sum_both((y32 * y32).sum(-1, keepdim=True)) / (cfg.ssm_expand * cfg.d_model)
    y = (y32 * torch.rsqrt(var + cfg.norm_eps) * p["norm_w"].float()).to(y.dtype)
    return tp.reduce(project(y, p["out_proj"])), {"conv": new_conv, "ssm": state}


def init_mamba_cache(cfg, B, dtype, device):
    d_in, nheads, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((B, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((B, nheads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }
