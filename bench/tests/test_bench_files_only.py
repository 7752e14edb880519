"""A configuration added by files alone.  A copy of the benchmark
(``BENCHMARK.json`` and ``bench/``, the port beside it) gains one
configuration, one traffic mix and one check, two entries in
``BENCHMARK.json`` and its name in ``tokens_per_s``'s cells (so the
per-layer metrics that move that rate are its too); the configuration's
``reference`` names a module of its own that wraps the plain decoder and
says on standard error each time the harness asks it for something.  The new cell, rehearsed on the
CPU at smoke size through ``bench/run.py`` as ``test_bench_run`` does,
prints the contract's line, ``correct`` true, and its ``mfu`` and its
check came from that module; with logits that are wrong, ``correct``
is false."""

import json
import shutil

import pytest

from bench.tests.test_bench_run import ROOT, rehearse

CELL = "files-only.tiny"

COUNTING = '''
import sys

from bench.reference import decoder
from bench.reference.decoder import Weights  # noqa: F401

WRONG = {wrong}


def _asked(what):
    print(f"counting-reference {{what}}", file=sys.stderr)


def spec(cfg_file):
    _asked("spec")
    return decoder.spec(cfg_file)


def check_program(spec, cfg):
    _asked("check_program")
    return decoder.check_program(spec, cfg)


def logits(spec, W, tokens, groups, at):
    _asked("logits")
    out = decoder.logits(spec, W, tokens, groups, at)
    # wrong: every logit moved to the next token id
    return out.roll(1, dims=-1) if WRONG else out


def model_flops(spec, B, S, start):
    _asked("model_flops")
    return decoder.model_flops(spec, B, S, start)
'''


def _checkout(tmp_path, wrong: bool):
    """The copy, with the cell's files and entries added."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src", target_is_directory=True)
    bench = tmp_path / "bench"
    (bench / "reference" / "counting.py").write_text(
        COUNTING.format(wrong=wrong))
    cfg = json.loads((bench / "configs" / "internlm2-20b.json").read_text())
    cfg.update(name="files-only", reference="bench/reference/counting.py")
    (bench / "configs" / "files-only.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        {"slots": 2, "streams": 4, "prompt_len": 40, "gen_len": 4}))
    (bench / "checks" / f"{CELL}.json").write_text(json.dumps(
        {"sample_streams": 4, "limits": {"gap_max": 0.3}}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "files-only", "source": cfg["source"],
        "file": "bench/configs/files-only.json", "reduced": [],
        "why": "a configuration with a reference module of its own"})
    spec["workloads"].append({
        "name": CELL, "config": "files-only", "traffic": "tiny", "chips": 1,
        "why": "4 prompts of 40, 4 tokens each, 2 slots"})
    for m in spec["end_to_end"]:
        if m["name"] == "tokens_per_s":
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


@pytest.mark.parametrize("wrong,trace", [(False, 1), (True, 0)],
                         ids=["own_reference", "wrong_logits"])
def test_a_configuration_added_by_files_alone(tmp_path, wrong, trace):
    rc, last, err = rehearse(CELL, trace=trace,
                             cwd=_checkout(tmp_path, wrong))
    assert rc == 0, err
    asked = {line.split()[1] for line in err.splitlines()
             if line.startswith("counting-reference ")}
    assert last["correct"] is (not wrong), last["checks"]
    assert last["attempted"] % 4 == 0 and last["failed"] == 0
    assert list(last["checks"]) == ["gap_max"]
    if wrong:
        assert {"spec", "check_program", "logits"} <= asked
        assert last["checks"]["gap_max"]["value"] > 0.3
    else:
        assert asked == {"spec", "check_program", "logits",
                         "model_flops"}
        assert last["metrics"]["mfu"]["value"] > 0
