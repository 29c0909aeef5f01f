"""The logical axes of the port's weights (``repro``'s init boxes each
weight with them).

The port's weights carry no axes of their own: ``WEIGHT_AXES`` names them
by where a tensor lives in a ``DecoderLM`` (``param_where``: ``attn``,
``mlp``, ``moe``, ``shared``, or the model and block level) and its key,
with the axes the reference's init gives it (``repro/models/{attention,
transformer,moe,mla}.py``), without the stacked layer axis (the port keeps
one module per layer).  ``models.padding`` pads by them and
``parallel.rules.spec_for`` splits by them.
"""

from __future__ import annotations

# (where, key) -> logical axes; where is the ParameterDict a tensor sits in,
# "block" for a block's own tensors and "model" for the model's
_ATTN = {
    "wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"), "bv": ("kv_heads", "head_dim"),
    # MLA
    "w_dq": ("embed", "lora"), "q_norm": ("lora",), "w_uq": ("lora", "heads", "qk_dim"),
    "w_dkv": ("embed", "lora"), "kv_norm": ("lora",), "w_uk": ("lora", "heads", "qk_dim"),
    "w_uv": ("lora", "heads", "head_dim"),
}
_MLP = {"wg": ("embed", "ff"), "wu": ("embed", "ff"), "wd": ("ff", "embed")}
WEIGHT_AXES: dict[tuple[str, str], tuple] = {
    **{("attn", k): v for k, v in _ATTN.items()},
    **{("mlp", k): v for k, v in _MLP.items()},
    **{("shared", k): v for k, v in _MLP.items()},
    ("moe", "router"): ("embed", None),
    ("moe", "wg"): ("experts", "embed", "ff"),
    ("moe", "wu"): ("experts", "embed", "ff"),
    ("moe", "wd"): ("experts", "ff", "embed"),
    ("block", "ln1"): ("act_embed",), ("block", "ln2"): ("act_embed",),
    ("block", "ln"): ("act_embed",), ("block", "in_w"): ("embed", "embed"),
    ("model", "embed"): ("vocab", "embed"),
    ("model", "final_norm"): ("act_embed",),
    ("model", "lm_head"): ("embed", "vocab"),
}
# the expert-parallel form of the routed experts: experts split, ff whole
EP_AXES = {"wg": ("experts_ep", "embed", "ff"), "wu": ("experts_ep", "embed", "ff"),
           "wd": ("experts_ep", "ff", "embed")}


def weight_axes(where: str, key: str, moe_form: str = "tp") -> tuple | None:
    """The logical axes of the tensor ``key`` of ``where`` (None for one the
    table does not name: the recurrent blocks' tensors)."""
    if where == "moe" and moe_form == "ep" and key in EP_AXES:
        return EP_AXES[key]
    return WEIGHT_AXES.get((where, key))
