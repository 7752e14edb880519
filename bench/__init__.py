"""The benchmark of the PyTorch and CUDA port ``repro_torch`` on one
NVIDIA H100: ``python3 bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once
and prints one JSON line.  Nothing here imports ``jax`` or the JAX
package ``repro``; ``bench/reference/`` imports nothing of the port
either."""
