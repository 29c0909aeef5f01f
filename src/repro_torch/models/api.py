"""Model API (``repro.models.api``): init, caches, prefill, the tree-masked
``spec_forward`` and the chain/decode forwards, on one device.

Token, embedding, encoder-state, position and row arguments may be tensors
or numpy arrays; they are moved to the model's device.  A prefill takes
token ids or embeddings (musicgen's stub frontend feeds frame embeddings;
its decode still takes token ids through the embedding table) and, for a
model with cross blocks, the stub encoder states; the cached forwards read
the encoder K/V that the prefill cached.  The cached forwards write K/V rows into the
cache in place and return new mamba2 and rwkv6 state tensors (the input
cache keeps its state; ``models/transformer.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
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
    cfg: ModelConfig
    device: torch.device

    # ---- construction ----------------------------------------------------
    def init(self, seed: int) -> DecoderLM:
        return init_model(self.cfg, seed, self.device)

    def init_cache(self, B, S_max, dtype=None):
        return init_cache(self.cfg, B, S_max, getattr(torch, dtype or self.cfg.dtype), self.device)

    def _dev(self, x, dtype=torch.int32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ---- embedding helpers -------------------------------------------------
    def _embed(self, params, tokens=None, embeds=None):
        """Token ids through the embedding table, or ``embeds`` [B, S, d]
        (a stub frontend's frame embeddings) cast to the compute dtype."""
        if embeds is not None:
            return self._dev(embeds, getattr(torch, self.cfg.dtype))
        return embed_tokens(self.cfg, params, self._dev(tokens))

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
        ctx = Ctx(mode="full", make_cache=S_max or S, positions=positions, enc=enc)
        h, cache = apply_model(self.cfg, params, h, ctx)
        cache["len"] = S
        return logits_from_hidden(self.cfg, params, h), cache

    def spec_forward(self, params, cache, tokens, positions, row_idx, attn_mask):
        """Tree-structured forward: K/V written at ``row_idx``, attention under
        the non-square ``attn_mask`` [B, n, S_max].  ``cache['len']`` is left
        as it is — the engine owns length bookkeeping (core/kv.py)."""
        h = embed_tokens(self.cfg, params, self._dev(tokens))
        ctx = Ctx(mode="cached", positions=self._dev(positions), row_idx=self._dev(row_idx),
                  attn_mask=self._dev(attn_mask, torch.bool))
        h, nc = apply_model(self.cfg, params, h, ctx, cache=cache)
        nc["len"] = cache["len"]
        return logits_from_hidden(self.cfg, params, h), nc

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
        h = embed_tokens(self.cfg, params, tokens)
        ctx = Ctx(mode="cached", positions=positions, row_idx=positions, attn_mask=attn_mask,
                  row_start=start, n_commit=int(n_commit))
        h, nc = apply_model(self.cfg, params, h, ctx, cache=cache)
        nc["len"] = start + int(n_commit)
        return logits_from_hidden(self.cfg, params, h), nc

    def decode_step(self, params, cache, tokens, S_max):
        """tokens [B, 1] -> (logits [B, 1, V], cache')."""
        return self.chain_forward(params, cache, tokens, 1, S_max)

    @property
    def uses_chain_spec(self) -> bool:
        return self.cfg.sub_quadratic  # SSM/hybrid: tree spec inapplicable

    def needs_enc(self) -> bool:
        return any("cross" in unit for unit, _ in build_plan(self.cfg))


def make_model(cfg: ModelConfig, device=None) -> Model:
    """``device`` None means CUDA; without a CUDA device that raises."""
    return Model(cfg, resolve_device(device))
