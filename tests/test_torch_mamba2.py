"""The port's Mamba2 block and zamba2 against the JAX package, on the CPU.

Weights are the reference's own (``mamba2_params`` / ``init_params`` with
``jax.random``), carried over through numpy; inputs come from numpy.
Tolerances: 1e-5 for port vs JAX in f32 (sums taken in another order and
the scan in chunks of another size); 1e-4 for prefill + decode vs the
full forward, as in the reference's ``test_decode_matches_teacher_forcing``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.serving.engine import JaxServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import cache_from_numpy  # noqa: E402
from repro_torch.convert import cache_to_numpy  # noqa: E402
from repro_torch.convert import load_numpy_, params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (decode_step, forward_logits,  # noqa: E402
                                init_params, prefill)
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.serving.engine import TorchServeEngine  # noqa: E402

ARCH = "zamba2-2.7b"

# the reference's entry points, compiled once per config
_jprefill = jax.jit(jprefill, static_argnums=(0,), static_argnames="max_len")
_jdecode = jax.jit(jdecode_step, static_argnums=(0,))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _cfgs(**over):
    over.setdefault("dtype", "float32")
    return (dataclasses.replace(jget_smoke(ARCH), **over),
            dataclasses.replace(get_smoke_config(ARCH), **over))


# ---------------------------------------------------------------------------
# the Mamba2 block alone
# ---------------------------------------------------------------------------

D_MODEL, D_INNER, N_STATE, N_HEADS, CONV_K = 32, 64, 16, 4, 4
HEAD_DIM = D_INNER // N_HEADS
KW = dict(d_inner=D_INNER, n_state=N_STATE, n_heads=N_HEADS,
          head_dim=HEAD_DIM)


def _block(seed=0):
    """The reference's block parameters and the port's copy of them, with
    nonzero conv biases, A_log and D so that every term is exercised."""
    jp = JM.mamba2_params(jax.random.key(seed), D_MODEL, D_INNER, N_STATE,
                          N_HEADS, CONV_K, jnp.float32)
    rng = np.random.default_rng(seed)
    jp = _np(jp)
    for name in ("conv_x_b", "conv_B_b", "conv_C_b", "A_log", "D"):
        jp[name] = (rng.standard_normal(jp[name].shape) * 0.3).astype(
            np.float32)
    p = M.Mamba2(D_MODEL, D_INNER, N_STATE, N_HEADS, CONV_K, device="cpu",
                 dtype=torch.float32)
    load_numpy_(p, jp)
    return {k: jnp.asarray(v) for k, v in jp.items()}, p


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((CONV_K, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    state = (rng.standard_normal((2, CONV_K - 1, 12)).astype(np.float32)
             if with_state else None)
    want, want_state = JM._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if state is None else jnp.asarray(state))
    got, got_state = M._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if state is None else torch.from_numpy(state))
    _close(got, want)
    _close(got_state, want_state)


@pytest.mark.parametrize("chunk", [64, 256])
def test_ssd_chunked_matches_reference_at_its_chunk(chunk):
    """The model's plain scan with the chunk given, against the reference's
    ``ssd_chunked`` at the same chunk, from a given state."""
    rng = np.random.default_rng(4)
    B, S, H, P, N = 2, 256, 3, 16, 16
    xdt = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    Bm, Cm = (rng.standard_normal((2, B, S, N)) * 0.5).astype(np.float32)
    init = rng.standard_normal((B, H, P, N)).astype(np.float32)
    arrays = (xdt, a, Bm, Cm, init)
    want_y, want_state = JM.ssd_chunked(*map(jnp.asarray, arrays),
                                        chunk=chunk)
    y, state = M.ssd_chunked(*map(torch.from_numpy, arrays), chunk=chunk)
    _close(y, want_y)
    _close(state, want_state)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_reference(with_state):
    jp, p = _block()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, D_MODEL)).astype(np.float32)
    ssm = conv = jssm = jconv = None
    if with_state:
        ssm = rng.standard_normal((2, N_HEADS, HEAD_DIM, N_STATE)).astype(
            np.float32)
        conv = {"x": rng.standard_normal((2, CONV_K - 1, D_INNER)),
                "B": rng.standard_normal((2, CONV_K - 1, N_STATE)),
                "C": rng.standard_normal((2, CONV_K - 1, N_STATE))}
        conv = {k: v.astype(np.float32) for k, v in conv.items()}
        jssm, jconv = jnp.asarray(ssm), jax.tree.map(jnp.asarray, conv)
        ssm = torch.from_numpy(ssm)
        conv = {k: torch.from_numpy(v) for k, v in conv.items()}
    want, (want_ssm, want_conv) = JM.mamba2_forward(
        jp, jnp.asarray(x), ssm_state=jssm, conv_state=jconv,
        return_state=True, **KW)
    got, (got_ssm, got_conv) = M.mamba2_forward(
        p, torch.from_numpy(x), ssm_state=ssm, conv_state=conv,
        return_state=True, **KW)
    _close(got, want)
    _close(got_ssm, want_ssm)
    assert got_ssm.dtype == torch.float32
    for k in ("x", "B", "C"):
        _close(got_conv[k], want_conv[k])
    # without return_state: the output alone, the same
    _close(M.mamba2_forward(p, torch.from_numpy(x), ssm_state=ssm,
                            conv_state=conv, **KW), want)


def test_mamba2_decode_step_matches_reference():
    jp, p = _block(3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, D_MODEL)).astype(np.float32)
    ssm = rng.standard_normal((2, N_HEADS, HEAD_DIM, N_STATE)).astype(
        np.float32)
    conv = {"x": rng.standard_normal((2, CONV_K - 1, D_INNER)),
            "B": rng.standard_normal((2, CONV_K - 1, N_STATE)),
            "C": rng.standard_normal((2, CONV_K - 1, N_STATE))}
    conv = {k: v.astype(np.float32) for k, v in conv.items()}
    want, want_ssm, want_conv = JM.mamba2_decode_step(
        jp, jnp.asarray(x), jnp.asarray(ssm),
        jax.tree.map(jnp.asarray, conv), **KW)
    got, got_ssm, got_conv = M.mamba2_decode_step(
        p, torch.from_numpy(x), torch.from_numpy(ssm),
        {k: torch.from_numpy(v) for k, v in conv.items()}, **KW)
    _close(got, want)
    _close(got_ssm, want_ssm)
    for k in ("x", "B", "C"):
        _close(got_conv[k], want_conv[k])


# ---------------------------------------------------------------------------
# zamba2 smoke: the Mamba2 stack with its shared attention block
# ---------------------------------------------------------------------------


def test_init_params_shapes_dtypes_and_laws_match_reference():
    """Every parameter of the reference's pytree, the shared block's
    included, with its shape and dtype: the model's bf16, and f32 for
    A_log, dt_bias and D."""
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    assert cfg.dtype == "bfloat16"
    jtree = jinit_params(jcfg, jax.random.key(0))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}
    seen = set()
    for name, p in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            key = "/".join(["layers"] + parts[2:])
            want_shape = flat[key].shape[1:]
            assert flat[key].shape[0] == cfg.n_layers
        else:
            key = "/".join(parts)
            want_shape = flat[key].shape
        assert tuple(p.shape) == tuple(want_shape), name
        assert str(p.dtype).replace("torch.", "") == str(flat[key].dtype)
        seen.add(key)
    assert seen == set(flat)
    m = params.layers[0].mamba
    for t in (m.A_log, m.dt_bias, m.D):
        assert t.dtype == torch.float32
    assert bool((m.A_log == 0).all()) and bool((m.dt_bias == -2).all())
    assert bool((m.D == 1).all()) and bool((m.conv_x_b == 0).all())
    assert abs(m.conv_x_w.float().std().item() - 0.1) < 0.02
    assert abs(m.w_z.float().std().item() * cfg.d_model ** 0.5 - 1) < 0.1
    assert bool((params.shared_attn.ln2 == 1).all())


def _run_both(jcfg, cfg, toks, max_len, n_decode, key=1):
    jparams = jinit_params(jcfg, jax.random.key(key))
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    S = toks.shape[1] - n_decode
    jlogits, jcache = _jprefill(jcfg, jparams, {"tokens": jnp.asarray(
        toks[:, :S])}, max_len=max_len)
    logits, cache = prefill(cfg, params,
                            {"tokens": torch.from_numpy(toks[:, :S])},
                            max_len)
    pairs = [(logits, jlogits, cache_to_numpy(cache), jcache)]
    for t in range(n_decode):
        tok = toks[:, S + t][:, None]
        jlogits, jcache = _jdecode(jcfg, jparams, jcache, jnp.asarray(tok))
        logits, cache = decode_step(cfg, params, cache, torch.from_numpy(tok))
        pairs.append((logits, jlogits, cache_to_numpy(cache), jcache))
    return params, pairs


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_prefill_and_decode_match_jax():
    """Prefill logits and the whole cache (SSM states, conv states, the
    shared block's ring buffers), then 4 decode steps."""
    jcfg, cfg = _cfgs()
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24 + 4)).astype(np.int32)
    _, pairs = _run_both(jcfg, cfg, toks, max_len=32, n_decode=4)
    for logits, jlogits, cache, jcache in pairs:
        assert tuple(logits.shape) == tuple(jlogits.shape)
        _close(logits, jlogits)
        got, want = _leaves(cache), _leaves(jcache)
        assert sorted(got) == sorted(want)
        assert len(cache["shared"]["k"]) == cfg.n_layers // 3
        for name in want:
            _close(got[name], want[name])


def test_cache_numpy_round_trip():
    jcfg, cfg = _cfgs()
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jparams = jinit_params(jcfg, jax.random.key(1))
    _, jcache = _jprefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                          max_len=16)
    cache = cache_from_numpy(_np(jcache), "cpu", torch.bfloat16)
    assert cache["pos"] == 10 and len(cache["layers"]) == cfg.n_layers
    assert len(cache["shared"]) == cfg.n_layers // cfg.shared_attn_every
    assert cache["layers"][0]["ssm"].dtype == torch.float32
    assert cache["layers"][0]["conv"]["x"].dtype == torch.bfloat16
    cache = cache_from_numpy(_np(jcache), "cpu")
    back, want = _leaves(cache_to_numpy(cache)), _leaves(jcache)
    assert sorted(back) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(back[name], want[name])
    # decoding on from the carried-over cache matches the reference
    tok = toks[:, -1:]
    jl, _ = _jdecode(jcfg, jparams, jcache, jnp.asarray(tok))
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    logits, _ = decode_step(cfg, params, cache, torch.from_numpy(tok))
    _close(logits, jl)


def test_decode_matches_teacher_forcing():
    """Port of test_decode_matches_teacher_forcing[zamba2-2.7b]: prefill +
    decode logits equal the full forward at the same positions."""
    jcfg, cfg = _cfgs()
    B, S, EXTRA = 2, 24, 4
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    params, pairs = _run_both(jcfg, cfg, toks, max_len=S + EXTRA,
                              n_decode=EXTRA)
    ref = forward_logits(cfg, params, torch.from_numpy(toks)).numpy()
    errs = [np.abs(logits[:, 0].numpy() - ref[:, S - 1 + t]).max()
            for t, (logits, _, _, _) in enumerate(pairs)]
    assert max(errs) < 1e-4, errs


def test_serve_engine_matches_jax_engine():
    """The examples/serve_gcr.py setting on zamba2 smoke, in f32: the same
    tokens as JaxServeEngine and GCR's 8 fast / 2 parked admits."""
    jcfg, cfg = _cfgs()
    jparams = jinit_params(jcfg, jax.random.key(0))
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 12)).astype(np.int32)
    jeng = JaxServeEngine(jcfg, jparams, n_slots=3, max_len=24,
                          admission_kind="gcr")
    eng = TorchServeEngine(cfg, params, n_slots=3, max_len=24,
                           admission_kind="gcr", device="cpu")
    want = jeng.generate(prompts, gen_len=8)
    got = eng.generate(prompts, gen_len=8)
    np.testing.assert_array_equal(got, want)
    assert (eng.admission.stat_fast, eng.admission.stat_parked) == (8, 2)
    assert (jeng.admission.stat_fast, jeng.admission.stat_parked) == (8, 2)


def test_serve_launcher_runs_zamba2_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--streams", "4",
                "--slots", "2", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "arch=zamba2-2.7b" in out and "device=cpu" in out
    assert "fast admits: 4" in out
