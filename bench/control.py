"""The readings that a cell's correctness limits are set from, on the
card at the cell's own size (not run by the benchmark's runs):

    python3 bench/control.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--out FILE]

For each seed: the weights and one job of the cell's mix, served by the
program as a run serves it, the run's sample of its streams, and the
numbers the run compares (``harness.gap_numbers``) against the float32
reference of the configuration's ``reference`` module.  For each control
seed also the control: that reference with every matrix rounded through
float8 e4m3, the precision below the configuration's bf16, in the
program's place: the token it puts first at each served position, judged
by the same numbers.  One JSON line a seed, and all of them in
``--out``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None, *, device="cuda", smoke=False) -> int:
    import torch

    from bench import harness, spec as S, traffic, weights
    from repro_torch.serving.engine import TorchServeEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    ns = ap.parse_args(argv)
    device = torch.device(device)
    bench = S.benchmark()
    cell = S.workload(bench, ns.workload)
    cfg_file = S.sized(S.config_file(bench, cell["config"]), smoke)
    mix = S.sized(S.traffic(cell["traffic"]), smoke)
    chk = S.check(ns.workload)
    ref = S.reference(cfg_file)
    spec = ref.spec(cfg_file)
    cfg = harness.program_config(ref, cfg_file, spec, smoke)
    controls = {int(s) for s in ns.control_seeds.split(",") if s}
    rows = []
    for seed in [int(s) for s in ns.seeds.split(",")]:
        t = time.perf_counter()
        W = weights.make(cfg, seed, device)
        params = weights.to_program(cfg, W)
        eng = TorchServeEngine(cfg, params, n_slots=mix["slots"],
                               max_len=mix["prompt_len"] + mix["gen_len"],
                               admission_kind="gcr", device=device)
        prompts = traffic.job_prompts(mix, spec["vocab_size"], seed, 0)
        jobs = [(prompts, eng.generate(prompts, mix["gen_len"]))]
        t_job = time.perf_counter() - t
        del eng, params
        gc.collect()
        seqs, served = harness.sampled(mix, jobs, chk, seed)
        t = time.perf_counter()
        logits = harness.reference_logits(ref, spec, W, mix, seqs, device)
        row = {"workload": ns.workload, "seed": seed,
               "program": harness.gap_numbers(logits, served),
               "job_s": t_job, "reference_s": time.perf_counter() - t}
        if seed in controls:
            ctrl = harness.reference_logits(ref, spec, W, mix, seqs, device,
                                            fp8=True)
            row["control_fp8"] = harness.gap_numbers(logits,
                                                     ctrl.argmax(-1))
            del ctrl
        del logits, W
        gc.collect()
        if device.type == "cuda":
            row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rows.append(row)
    if ns.out:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    print(f"control: {len(rows)} seeds in {time.perf_counter() - T_START:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
