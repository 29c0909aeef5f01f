"""A rank program for ``tests/test_torch_split_engine.py``: the two roles of
a split of two ranks each wait for the other's buffer, so no rank sends and
both block in their broadcast until something ends them."""

from repro_torch.parallel.split import make_split


def crossed_exchange(group):
    split = make_split(group, 1)
    split.share(None, "draft" if split.role == "target" else "target", (1, 4))
