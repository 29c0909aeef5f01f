"""The shapes at which a run calls each kernel wrapper.

``ShapeLog(ops).install()`` wraps the wrappers of
``repro_torch.kernels.ops`` so that every call records its shape and dtype
in ``seen`` (wrapper name -> a set of keys, picklable, so that a spawned
rank can hand its set back); ``uninstall`` puts the wrappers back.  A
check can then hold each kernel against its plain version at exactly the
shapes a path launched it with.
"""

from __future__ import annotations


class ShapeLog:
    """The shapes at which a run calls each kernel wrapper: ``install``
    wraps the wrappers in ``ops`` (the launch counts stay the wrappers'
    own), ``uninstall`` puts them back."""

    KEYS = {  # wrapper -> the shape of one call, from its arguments
        "tree_attention": lambda q, k, v, mask, kv_bound=None: (
            tuple(q.shape) + tuple(k.shape[1:3])),
        "decode_attention": lambda q, k, v, length: tuple(q.shape) + tuple(k.shape[1:3]),
        "fused_swiglu": lambda x, wg, wu: tuple(x.shape) + (wg.shape[1],),
        "kv_move_rows": lambda arr, src, dst, mask, donate=False: (
            tuple(arr.shape), src.shape[1], bool(donate)),
        "kv_move_leaves": lambda leaves, src, dst, mask, donate=False: (
            tuple(tuple(t.shape) for t in leaves), src.shape[1], bool(donate)),
        "slot_write_rows": lambda leaves, donors, slot: (
            tuple(tuple(t.shape) for t in leaves), donors is None),
        "int4_matmul": lambda x, qweight, scales, zeros, group_size=128: (
            tuple(x.shape) + (qweight.shape[1], group_size)),
        "stream_matmul": lambda x, w: (x.numel() // w.shape[0],) + tuple(w.shape),
        "stream_bmm": lambda x, w: tuple(x.shape) + (w.shape[2],),
        "latent_attention": lambda q_lat, q_rope, ckv, krope, mask, scale: (
            tuple(q_lat.shape) + (q_rope.shape[-1], ckv.shape[1])),
        "rms_norm": lambda x, weight, eps: (x.numel() // x.shape[-1], x.shape[-1]),
    }

    def __init__(self, ops):
        self.ops, self.seen, self.saved = ops, {name: set() for name in self.KEYS}, {}

    def install(self):
        for name, key in self.KEYS.items():
            fn = self.saved[name] = getattr(self.ops, name)

            def logged(*a, _fn=fn, _name=name, _key=key, **kw):
                first = a[0][0] if _name in ("slot_write_rows", "kv_move_leaves") else a[0]
                self.seen[_name].add(_key(*a, **kw) + (str(first.dtype),))
                return _fn(*a, **kw)

            setattr(self.ops, name, logged)

    def uninstall(self):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)
