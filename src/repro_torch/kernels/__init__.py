"""The port's hand-written Hopper kernels (``csrc/*.cu``), their build
(``build.py``), their plain PyTorch versions (``ref.py``) and the
device-dispatching wrappers (``ops.py``)."""
