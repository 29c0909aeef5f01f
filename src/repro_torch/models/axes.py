"""The logical axes of the port's weights (``repro``'s init boxes each
weight with them).

The port's weights carry no axes of their own: ``WEIGHT_AXES`` names them
by where a tensor lives in a ``DecoderLM`` (``param_where``: ``attn``,
``mlp``, ``moe``, ``shared``, ``mamba``, ``tm``, or the model and block
level) and its key, with the axes the reference's init gives it
(``repro/models/{attention,transformer,moe,mla,mamba2,rwkv6}.py``), without
the stacked layer axis (the port keeps one module per layer).
``models.padding`` pads by them and ``parallel.shard`` splits by them.

Where the port joins several of the reference's tensors along one dimension
(mamba2's ``w_in`` = w_z | w_x | w_bc | w_dt, ``conv_w`` and ``conv_b`` =
the x | BC channels), that dimension's entry is a tuple, one logical axis
per joined segment in order (``models.mamba2.segments`` gives their
widths): its split is a set of column ranges, not one axis.  rwkv6's
``w_rkvg`` stacks w_r, w_k, w_v and w_g on a leading axis of its own.
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
_MAMBA = {  # repro/models/mamba2.py:26-47, in this port's joined layout
    "w_in": ("embed", ("inner", "inner", None, "inner")),  # z | x | BC | dt
    "conv_w": ("conv", ("inner", None)), "conv_b": (("inner", None),),  # x | BC channels
    "a_log": ("inner",), "dt_bias": ("inner",), "d_skip": ("inner",), "norm_w": ("inner",),
    "out_proj": ("inner", "embed"),
}
_RWKV = {  # repro/models/rwkv6.py:28-52; w_rkvg stacks w_r, w_k, w_v, w_g
    "mu_tm": ("layers", "embed"), "w_rkvg": (None, "embed", "inner"), "w_o": ("inner", "embed"),
    "decay_base": ("inner",), "decay_a": ("embed", "lora"), "decay_b": ("lora", "inner"),
    "bonus_u": ("inner", None), "ln_x": ("inner",), "mu_cm": ("layers", "embed"),
    "cm_k": ("embed", "ff"), "cm_v": ("ff", "embed"), "cm_r": ("embed", "inner"),
}
WEIGHT_AXES: dict[tuple[str, str], tuple] = {
    **{("attn", k): v for k, v in _ATTN.items()},
    **{("mlp", k): v for k, v in _MLP.items()},
    **{("shared", k): v for k, v in _MLP.items()},
    **{("mamba", k): v for k, v in _MAMBA.items()},
    **{("tm", k): v for k, v in _RWKV.items()},
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
    table does not name)."""
    if where == "moe" and moe_form == "ep" and key in EP_AXES:
        return EP_AXES[key]
    return WEIGHT_AXES.get((where, key))
