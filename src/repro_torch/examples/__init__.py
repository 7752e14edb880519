"""The port's counterparts of ``examples/``, run as
``python -m repro_torch.examples.<name>``: ``serve_gcr`` (the real-model
engine under GCR admission, then the virtual-time load sweep) and
``train_100m`` (a ~100M-parameter qwen3-shaped model through the whole
training stack, with a simulated failure and resume)."""
