"""The port's counterparts of ``examples/``, run as
``python -m repro_torch.examples.<name>``: ``serve_gcr`` (the real-model
engine under GCR admission, then the virtual-time load sweep),
``train_100m`` (a ~100M-parameter qwen3-shaped model through the whole
training stack, with a simulated failure and resume), ``quickstart`` (the
lock simulator and the virtual-time engine with and without admission),
``cluster_demo`` (routing x admission at 2x a fleet's saturation, and the
control plane), ``trace_demo`` (a fleet's collapse in time, exported for
Perfetto) and ``lock_bench`` (the lock layer over real host threads).
The last four touch no device."""
