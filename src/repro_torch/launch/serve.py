"""Serving launcher: ``python -m repro_torch.launch.serve [--device cuda]``.

Runs the real-model engine with GCR admission over the reduced (smoke)
model, as the reference launcher's default mode does; weights are drawn
from a seeded ``torch.Generator``.  The reference's ``--fleet-sweep`` and
``--cluster`` modes are not ported yet.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..configs import ARCHS, get_smoke_config
from ..models import init_params
from ..serving.engine import TorchServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCHS)
    ap.add_argument("--admission", default="gcr",
                    choices=["none", "gcr", "gcr_pod"])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises if absent")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    eng = TorchServeEngine(cfg, params, n_slots=args.slots,
                           max_len=args.prompt_len + args.gen_len + 4,
                           admission_kind=args.admission, device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.streams, args.prompt_len)).astype(np.int32)
    out = eng.generate(prompts, gen_len=args.gen_len)
    print(f"arch={cfg.name} streams={args.streams} slots={args.slots} "
          f"admission={args.admission} device={device}")
    print(f"fast admits: {getattr(eng.admission, 'stat_fast', 0)}  "
          f"parked: {getattr(eng.admission, 'stat_parked', 0)}")
    for i in range(min(3, args.streams)):
        print(f"stream {i}: {out[i].tolist()}")


if __name__ == "__main__":
    main()
