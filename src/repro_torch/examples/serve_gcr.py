"""Serve a real (reduced) model with GCR admission: more streams than
slots, parked streams admitted as slots free, plus the virtual-time fleet
engine showing the collapse-avoidance curve under the H100 step costs.

The port of ``examples/serve_gcr.py``.  Run:

    PYTHONPATH=src python -m repro_torch.examples.serve_gcr [--device cpu]

Without ``--device`` the real-model demo runs on CUDA and raises where
there is none; the fleet demo runs in virtual time.
"""

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_smoke_config
from ..models import init_params
from ..serving.engine import (Request, SimServeEngine, TorchServeEngine,
                              make_admission)


def real_model_demo(device) -> None:
    cfg = get_smoke_config("qwen3-0.6b")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    eng = TorchServeEngine(cfg, params, n_slots=3, max_len=32,
                           admission_kind="gcr", device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 12)).astype(np.int32)
    out = eng.generate(prompts, gen_len=6)
    print(f"== real-model engine (8 streams, 3 slots, GCR admission, "
          f"{device}) ==")
    print(f"generated shape: {out.shape}; "
          f"fast admits: {eng.admission.stat_fast}, "
          f"parked: {eng.admission.stat_parked}")
    print("first stream tokens:", out[0].tolist())


def fleet_demo() -> None:
    print("\n== fleet engine: offered load sweep (tok/s) ==")
    rng = np.random.default_rng(1)

    def load(n):
        return [Request(rid=i, prompt_len=int(rng.integers(256, 1024)),
                        gen_len=int(rng.integers(64, 256)), pod=i % 2,
                        arrive_ms=float(rng.uniform(0, 500)))
                for i in range(n)]

    print(f"{'streams':>8} {'none':>10} {'gcr':>10} {'gcr_pod':>10}")
    for n in [256, 1024, 4096]:
        row = []
        for kind in ["none", "gcr", "gcr_pod"]:
            adm = make_admission(kind, active_limit=384, n_pods=2)
            row.append(SimServeEngine(adm).run(load(n), max_ms=600_000)
                       .token_throughput)
        print(f"{n:>8} {row[0]:>10,.0f} {row[1]:>10,.0f} {row[2]:>10,.0f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises if absent")
    args = ap.parse_args(argv)
    real_model_demo(resolve_device(args.device))
    fleet_demo()


if __name__ == "__main__":
    main()
