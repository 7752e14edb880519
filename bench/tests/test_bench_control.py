"""The control that every cell's limit must catch: the float32
reference with its matrices rounded through float8 e4m3 (the precision
below the configurations' bf16) in the program's place.

On the CPU: the rounding itself, and at internlm2's smoke size the
control reading far above the program.  On the card (marked ``gpu``,
skipped without one), ``bench/control.py`` at each cell's own size on
three seeds: the program's number within the cell's limit on every
seed, the control's beyond it on every seed:

    PYTHONPATH=src python -m pytest -q -m gpu bench/tests/test_bench_control.py
"""

import json

import pytest
import torch

from bench import spec as S
from bench.tests.test_bench_run import CELLS


def test_fp8_round_is_float8_e4m3_with_one_scale():
    # the control's rounding, as the configurations' reference has it
    decoder = S.reference(S.config_file(S.benchmark(), "internlm2-20b"))
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    got = decoder.fp8_round(w)
    scale = w.abs().max() / decoder.FP8_MAX
    want = (w / scale).to(torch.float8_e4m3fn).float() * scale
    assert torch.equal(got, want)
    # 3 mantissa bits: within half a step, 1/16 of the value, for normals
    big = w.abs() > scale * 2.0 ** -6
    assert ((got - w).abs()[big] <= w.abs()[big] / 16 + 1e-7).all()
    # an expert's matrix has its own scale
    stack = decoder.fp8_round(torch.stack([w, 100 * w]), per=1)
    assert torch.equal(stack[0], got)
    torch.testing.assert_close(stack[1], 100 * got, rtol=1e-6, atol=0)


def _control(workload, seeds, controls, device, smoke):
    import control

    lines = []

    class Out:
        def write(self, s):
            lines.append(s)

        def flush(self):
            pass

    import contextlib
    with contextlib.redirect_stdout(Out()):
        control.main(["--workload", workload, "--seeds", seeds,
                      "--control-seeds", controls], device=device,
                     smoke=smoke)
    return [json.loads(x) for x in "".join(lines).splitlines()
            if x.startswith("{")]


@pytest.fixture
def control_module(monkeypatch):
    monkeypatch.syspath_prepend(str(S.BENCH_DIR))


def test_control_reads_far_above_the_program_at_smoke(control_module):
    rows = _control("internlm2-20b.rag", "1,2,3", "1,2,3", "cpu", True)
    program = max(r["program"]["gap_max"] for r in rows)
    control = min(r["control_fp8"]["gap_max"] for r in rows)
    assert control > 3 * program


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes_on_card(control_module, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    limits = S.check(workload)["limits"]
    rows = _control(workload, "71,72,73", "71,72,73", "cuda", False)
    for r in rows:
        assert all(r["program"][k] <= lim for k, lim in limits.items()), r
        assert any(r["control_fp8"][k] > lim for k, lim in limits.items()), r
