"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``<name>/ref.py``) and its wrapper (``<name>/ops.py``)."""
