"""The port in bf16 against the JAX package in bf16, on the CPU.

The f32 tests (test_torch_model.py, test_torch_moe.py) hold the algorithm
to 1e-5.  Here both packages run in the served dtype and round at other
places (XLA and torch fuse differently, the combine and the norms round
in another order), so the logits differ by a few bf16 ulps; a real fault
(a wrong mask, rope or routing step) moves them by far more.

Tolerance: 8 bf16 ulps at the logits' scale, 8 * 2**(e - 7) where 2**e <=
max |logit| < 2**(e + 1).  On these inputs the differences read 2 to 4
ulps.  The MoE runs drop-free (capacity factor 8.0), so that capacity
cannot turn a bf16 difference into a dropped token; a routing near-tie
can still move a token to another expert (mixtral's smoke model, seed 0,
has a layer-0 top-2 margin of 3e-4 and differs by about 20 ulps).
"""

import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import decode_step, prefill  # noqa: E402

ULPS = 8

# the reference's entry points, compiled once per config
_jprefill = jax.jit(jprefill, static_argnums=(0,), static_argnames="max_len")
_jdecode = jax.jit(jdecode_step, static_argnums=(0,))


def _ulp_tol(want: np.ndarray) -> float:
    e = math.floor(math.log2(float(np.abs(want).max())))
    return ULPS * 2.0 ** (e - 7)


@pytest.mark.parametrize("arch,over", [
    ("qwen3-0.6b", {}),
    ("granite-moe-1b-a400m", {"moe_capacity_factor": 8.0}),
    ("zamba2-2.7b", {}),
    ("rwkv6-7b", {}),
    ("deepseek-7b", {}),
    ("internlm2-20b", {}),
    ("qwen3-8b", {}),
    ("whisper-base", {}),
    ("internvl2-2b", {}),
])
def test_bf16_prefill_and_decode_logits_match_jax(arch, over):
    jcfg = dataclasses.replace(jget_smoke(arch), **over)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    assert cfg.dtype == "bfloat16"
    jparams = jinit_params(jcfg, jax.random.key(1))
    params = params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), cfg,
        "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 24 + 3)).astype(np.int32)
    S = 24
    # the frontend's stub in bf16 in both (one rounding of the same f32)
    stubs = {}
    if cfg.frontend == "vision_stub":
        stubs["patches"] = rng.standard_normal(
            (2, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        stubs["frames"] = rng.standard_normal(
            (2, S // cfg.enc_seq_divisor, cfg.frontend_dim)).astype(
                np.float32)
    max_len = 32 + (cfg.n_patches if cfg.frontend == "vision_stub" else 0)
    jlogits, jcache = _jprefill(
        jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S]),
                        **{k: jnp.asarray(v, jnp.bfloat16)
                           for k, v in stubs.items()}}, max_len=max_len)
    logits, cache = prefill(
        cfg, params, {"tokens": torch.from_numpy(toks[:, :S]),
                      **{k: torch.from_numpy(v).to(torch.bfloat16)
                         for k, v in stubs.items()}}, max_len)
    for t in range(4):
        assert logits.dtype == torch.bfloat16
        want = np.asarray(jlogits, np.float32)
        got = logits.float().numpy()
        err, tol = float(np.abs(got - want).max()), _ulp_tol(want)
        assert err <= tol, (t, err, tol)
        if t == 3:
            break
        tok = toks[:, S + t][:, None]
        jlogits, jcache = _jdecode(jcfg, jparams, jcache, jnp.asarray(tok))
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(tok))
