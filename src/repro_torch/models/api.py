"""Model API (``repro.models.api``): init, caches, the training forward
``forward_train``, prefill, the tree-masked ``spec_forward`` and the
chain/decode forwards, on one device or sharded over a tensor-parallel
group (``group``, a ``parallel.TPGroup``: this rank's shards, padded by
``configs.resolve_for_tp``; ``parallel/shard.py``).  Sharded, every rank
calls the same methods on the same inputs and gets the whole logits.

Token, embedding, encoder-state, position and row arguments may be tensors
or numpy arrays; they are moved to the model's device.  A prefill takes
token ids or embeddings (musicgen's stub frontend feeds frame embeddings;
its decode still takes token ids through the embedding table) and, for a
model with cross blocks, the stub encoder states; the cached forwards read
the encoder K/V that the prefill cached.  The cached forwards write K/V rows into the
cache in place and return new mamba2 and rwkv6 state tensors (the input
cache keeps its state; ``models/transformer.py``).

Weights are frozen (no parameter requires a gradient), so no serving
forward builds an autograd graph; ``init(seed, trainable=True)`` gives a
trainer weights that do, and the serving engines refuse them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch import indexed_device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (
    Ctx,
    DecoderLM,
    apply_model,
    build_plan,
    embed_tokens,
    init_cache,
    init_model,
    logits_from_hidden,
)


@dataclasses.dataclass(frozen=True)
class Model:
    """``cfg`` is the model's published (unpadded) config; with ``group``
    the forward runs at this rank's shapes (``shard.local_cfg``) and
    ``moe_form`` ("tp" or "ep") picks the MoE's tensor-parallel form."""

    cfg: ModelConfig
    device: torch.device
    group: Any = None
    moe_form: str = "tp"

    @functools.cached_property
    def shard(self):
        """This rank's ``parallel.shard.Shard`` (None without a group)."""
        if self.group is None:
            return None
        from repro_torch.parallel.shard import Shard

        return Shard(self.cfg, self.group.rank, self.group.world, self.moe_form)

    @property
    def run_cfg(self) -> ModelConfig:
        """The config the forward runs at: ``cfg``, or this rank's."""
        return self.cfg if self.shard is None else self.shard.local_cfg

    @functools.cached_property
    def _vocab_tp(self):
        """The group the vocabulary is split over (None: whole on this rank)."""
        return self.group if self.shard is not None and self.shard.vocab_split else None

    def _ctx(self, **kw) -> Ctx:
        """A forward's ``Ctx`` with this rank's tensor-parallel layout."""
        return Ctx(tp=self.group, moe_ep=self.shard is not None and self.shard.ep, **kw)

    def _logits(self, params, h):
        return logits_from_hidden(self.run_cfg, params, h, self._vocab_tp)

    def _embed_ids(self, params, tokens):
        return embed_tokens(self.run_cfg, params, self._dev(tokens), self._vocab_tp)

    # ---- construction ----------------------------------------------------
    def init(self, seed: int, trainable: bool = False) -> DecoderLM:
        """Seeded weights; ``trainable`` makes every parameter require a
        gradient (a trainer's copy — the serving engines refuse it).  With
        a group, the unpadded model's draws, each padded and sliced as soon
        as it is drawn: a rank keeps its shards of the same weights."""
        place = None if self.shard is None else self.shard.tensor
        return init_model(self.cfg, seed, self.device, place).requires_grad_(trainable)

    def init_cache(self, B, S_max, dtype=None):
        return init_cache(self.run_cfg, B, S_max, getattr(torch, dtype or self.cfg.dtype),
                          self.device)

    def _dev(self, x, dtype=torch.int32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ---- embedding helpers -------------------------------------------------
    def _embed(self, params, tokens=None, embeds=None):
        """Token ids through the embedding table, or ``embeds`` [B, S, d]
        (a stub frontend's frame embeddings) cast to the compute dtype."""
        if embeds is not None:
            return self._dev(embeds, getattr(torch, self.cfg.dtype))
        return self._embed_ids(params, tokens)

    # ---- training ----------------------------------------------------------
    def forward_train(self, params, tokens=None, embeds=None, enc=None, remat: str = "none"):
        """Full causal forward -> logits [B, S, V]: no cache, differentiable
        in ``params`` (and in ``embeds``/``enc`` when they require a
        gradient).  ``remat="full"`` recomputes each unit in the backward
        (``transformer.apply_model``)."""
        h = self._embed(params, tokens, embeds)
        B, S, _ = h.shape
        positions = torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S)
        if enc is not None:
            enc = self._dev(enc, h.dtype)
        h, _ = apply_model(self.run_cfg, params, h,
                           self._ctx(mode="full", positions=positions, enc=enc), remat=remat)
        return self._logits(params, h)

    # ---- serving -----------------------------------------------------------
    def prefill(self, params, tokens=None, embeds=None, enc=None, S_max=None):
        """Returns (logits [B, S, V], cache with len=S).  ``embeds`` [B, S, d]
        stand in for ``tokens``; ``enc`` [B, n_enc, d] are the stub encoder
        states that a model with cross blocks attends (``needs_enc``)."""
        h = self._embed(params, tokens, embeds)
        B, S, _ = h.shape
        positions = torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S)
        if enc is not None:
            enc = self._dev(enc, h.dtype)
        ctx = self._ctx(mode="full", make_cache=S_max or S, positions=positions, enc=enc)
        h, cache = apply_model(self.run_cfg, params, h, ctx)
        cache["len"] = S
        return self._logits(params, h), cache

    def spec_forward(self, params, cache, tokens, positions, row_idx, attn_mask):
        """Tree-structured forward: K/V written at ``row_idx``, attention under
        the non-square ``attn_mask`` [B, n, S_max].  ``cache['len']`` is left
        as it is — the engine owns length bookkeeping (core/kv.py)."""
        h = self._embed_ids(params, tokens)
        ctx = self._ctx(mode="cached", positions=self._dev(positions), row_idx=self._dev(row_idx),
                        attn_mask=self._dev(attn_mask, torch.bool))
        h, nc = apply_model(self.run_cfg, params, h, ctx, cache=cache)
        nc["len"] = cache["len"]
        return self._logits(params, h), nc

    def chain_forward(self, params, cache, tokens, n_commit, S_max):
        """Chain-mode forward of n tokens starting at row cache['len'];
        returns (logits, cache') with cache'.len = len + n_commit.  State
        blocks commit exactly the first ``n_commit`` steps (a host int: the
        reference's mask arange(n) < n_commit, the same for every batch row);
        attention blocks write rows [len, len+n), and rows past the committed
        point are dead and overwritten next time."""
        tokens = self._dev(tokens)
        B, n = tokens.shape
        start = int(cache["len"])
        positions = start + torch.arange(n, dtype=torch.int32, device=self.device).expand(B, n)
        cols = torch.arange(S_max, dtype=torch.int32, device=self.device)
        attn_mask = cols[None, None, :] <= positions[:, :, None]
        if self.cfg.sliding_window:
            attn_mask &= cols[None, None, :] > positions[:, :, None] - self.cfg.sliding_window
        h = self._embed_ids(params, tokens)
        ctx = self._ctx(mode="cached", positions=positions, row_idx=positions,
                        attn_mask=attn_mask, row_start=start, n_commit=int(n_commit))
        h, nc = apply_model(self.run_cfg, params, h, ctx, cache=cache)
        nc["len"] = start + int(n_commit)
        return self._logits(params, h), nc

    def decode_step(self, params, cache, tokens, S_max):
        """tokens [B, 1] -> (logits [B, 1, V], cache')."""
        return self.chain_forward(params, cache, tokens, 1, S_max)

    @property
    def uses_chain_spec(self) -> bool:
        return self.cfg.sub_quadratic  # SSM/hybrid: tree spec inapplicable

    def needs_enc(self) -> bool:
        return any("cross" in unit for unit, _ in build_plan(self.cfg))


@dataclasses.dataclass(frozen=True)
class StandIn:
    """The other role's model on a rank of a split engine
    (``parallel/split.py``): its config only.  It holds no weights, cache or
    tree, and has no forward to call."""

    cfg: object
    group = None
    device = None


def make_model(cfg: ModelConfig, device=None, group=None, moe_form: str = "tp") -> Model:
    """``device`` None means CUDA; without a CUDA device that raises.  With
    ``group`` (a ``parallel.TPGroup``) the model is this rank's part of a
    tensor-parallel model on the group's device, of any family
    (``parallel/shard.py``)."""
    if group is not None:
        device = group.device if device is None else device
        if indexed_device(resolve_device(device)) != indexed_device(group.device):
            raise ValueError(f"the model's device {device} is not its group's {group.device}")
    return Model(cfg, resolve_device(device), group, moe_form)
