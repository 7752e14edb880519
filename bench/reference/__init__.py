"""The plain float32 references that decide ``correct``: plain PyTorch,
importing neither ``jax``, nor ``repro``, nor anything of the port
``repro_torch``."""
