"""The port's sharded train step for the MoE, Mamba2, RWKV6 and
encoder-decoder kinds across gloo ranks on the CPU, against the port's
single-device step (the harness and tolerances of
``tests/test_torch_parallel.py``)."""

from __future__ import annotations

import pytest

from test_torch_parallel import TOL, _check, _rank_train, spawn


@pytest.mark.parametrize("mesh_shape,overrides", [((2, 2), {}),
                                                  ((1, 4), {"n_experts": 6})])
def test_granite_sharded_step_matches_single_device(tmp_path, mesh_shape,
                                                    overrides):
    """(2, 2) with the smoke config's 8 experts: EP (4 experts a rank);
    (1, 4) with 6 experts, which do not divide 4: TP inside the experts,
    whose row-split products leave partial sums."""
    out = spawn(tmp_path, 4, _rank_train, mesh_shape, "granite-moe-1b-a400m",
                overrides, 2)
    _check(out, 2)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b",
                                  "whisper-base"])
def test_other_kinds_sharded_step_matches_single_device(tmp_path, arch):
    """zamba2 (ssd by heads), rwkv6 (wkv by heads) and whisper (non-causal
    and cross flash by heads) at (2, 2), one step each.  rwkv6's moments
    are held at 1e-4, the tolerance of its gradients in
    ``tests/test_torch_train.py``: even with its constants perturbed, its
    f32 gradients differ from f64 by 9e-5 of a leaf, so another f32
    summation order moves them by as much."""
    out = spawn(tmp_path, 4, _rank_train, (2, 2), arch, {}, 1)
    _check(out, 1, 1e-4 if arch == "rwkv6-7b" else TOL)
