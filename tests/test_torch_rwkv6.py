"""The port's RWKV6 block and rwkv6-7b against the JAX package, on the CPU.

Weights are the reference's own (``rwkv6_params`` / ``init_params`` with
``jax.random``), carried over through numpy, with the parameters that the
reference's init sets to constants perturbed in numpy before both
packages get them: every mix ``mu_*`` uniform in (0, 1), ``bonus_u``
N(0, 0.25), ``decay_w0`` uniform in (-6, -1), ``ln_x_w`` 1 + N(0, 0.01).
At the init's values (mixes 0.5, bonus 0, norm weight 1) a port that
swapped two mixes, dropped the bonus or read u transposed would pass.
Inputs come from numpy.  Sequence lengths held against the reference are
multiples of its chunk (16) or short (12): elsewhere the reference falls
back to one chunk of the whole sequence (see tests/test_torch_wkv.py).

Tolerances: 1e-5 for port vs JAX in f32 (sums taken in another order;
the port's WKV sums in f64, so the difference is the reference's f32
rounding), relative to the largest value for the whole model's logits
and WKV states, whose entries are sums of terms that cancel, so an entry
near 0 keeps the absolute error of the large ones; 1e-4 for prefill +
decode vs the full forward, as in the reference's
``test_decode_matches_teacher_forcing``.
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
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import rwkv6 as JR  # noqa: E402
from repro.serving.engine import JaxServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import cache_from_numpy  # noqa: E402
from repro_torch.convert import cache_to_numpy  # noqa: E402
from repro_torch.convert import load_numpy_, params_from_numpy  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (decode_step, forward_logits,  # noqa: E402
                                init_cache, init_params, prefill)
from repro_torch.models import rwkv6 as R  # noqa: E402
from repro_torch.serving.engine import TorchServeEngine  # noqa: E402

ARCH = "rwkv6-7b"
MUS = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr")

# the reference's entry points, compiled once per config
_jprefill = jax.jit(jprefill, static_argnums=(0,), static_argnames="max_len")
_jdecode = jax.jit(jdecode_step, static_argnums=(0,))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _close_scaled(got, want, tol=1e-5):
    """``_close`` on values divided by max(1, max |want|)."""
    scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
    _close(np.asarray(got, np.float32) / scale,
           np.asarray(want, np.float32) / scale, tol)


def _perturb(p, seed):
    """The perturbation of the module docstring, on a numpy dict of one
    block's (or a stack of blocks') RWKV6 parameters, in place."""
    rng = np.random.default_rng(seed)

    def draw(name, fn):
        p[name] = fn(p[name].shape).astype(np.float32)

    for name in MUS:
        draw(name, lambda s: rng.uniform(0.0, 1.0, s))
    draw("bonus_u", lambda s: rng.normal(0.0, 0.5, s))
    draw("decay_w0", lambda s: rng.uniform(-6.0, -1.0, s))
    draw("ln_x_w", lambda s: 1.0 + rng.normal(0.0, 0.1, s))
    return p


def _cfgs(**over):
    over.setdefault("dtype", "float32")
    return (dataclasses.replace(jget_smoke(ARCH), **over),
            dataclasses.replace(get_smoke_config(ARCH), **over))


def _model_params(jcfg, cfg, key=1, seed=0):
    """The reference's params with the rwkv subtree perturbed: (the JAX
    tree, the port's Transformer)."""
    tree = _np(jinit_params(jcfg, jax.random.key(key)))
    _perturb(tree["layers"]["rwkv"], seed)
    return _jnp(tree), params_from_numpy(tree, cfg, "cpu")


# ---------------------------------------------------------------------------
# the RWKV6 block alone
# ---------------------------------------------------------------------------

D_MODEL, D_FF, N_HEADS, HEAD_DIM = 64, 96, 4, 16
KW = dict(n_heads=N_HEADS, head_dim=HEAD_DIM)


def _block(seed=0):
    """The reference's block parameters, perturbed, and the port's copy."""
    jp = _perturb(_np(JR.rwkv6_params(jax.random.key(seed), D_MODEL, D_FF,
                                      N_HEADS, HEAD_DIM, jnp.float32)),
                  seed)
    p = R.RWKV6(D_MODEL, D_FF, N_HEADS, HEAD_DIM, device="cpu",
                dtype=torch.float32)
    load_numpy_(p, jp)
    return _jnp(jp), p


def _states(rng, B):
    shift = rng.standard_normal((B, 1, D_MODEL)).astype(np.float32)
    wkv = rng.standard_normal((B, N_HEADS, HEAD_DIM, HEAD_DIM)).astype(
        np.float32)
    return shift, wkv


def test_perturbation_moves_every_init_constant():
    jp, _ = _block()
    for name in MUS:
        assert float(jnp.std(jp[name])) > 0.2, name
    assert float(jnp.abs(jp["bonus_u"]).max()) > 0.5
    assert float(jp["decay_w0"].min()) < -4 < -2 < float(jp["decay_w0"].max())
    assert float(jnp.abs(jp["ln_x_w"] - 1).max()) > 0.1


@pytest.mark.parametrize("n_heads", [1, 4])
def test_group_norm_heads_matches_reference(n_heads):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 7, D_MODEL)) * 3 + 1).astype(np.float32)
    wt = rng.standard_normal((D_MODEL,)).astype(np.float32)
    want = JR._group_norm_heads(jnp.asarray(x), jnp.asarray(wt), n_heads)
    got = R._group_norm_heads(torch.from_numpy(x), torch.from_numpy(wt),
                              n_heads)
    _close(got, want)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(with_state):
    """Prefill time mix at S = 48 (three chunks), with and without the
    shift and WKV states, and the states it returns."""
    jp, p = _block()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 48, D_MODEL)).astype(np.float32)
    shift = wkv = None
    if with_state:
        shift, wkv = _states(rng, 2)
    want, want_shift, want_wkv = JR.rwkv6_time_mix(
        jp, jnp.asarray(x),
        shift_state=None if shift is None else jnp.asarray(shift),
        wkv_state=None if wkv is None else jnp.asarray(wkv),
        return_state=True, **KW)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got, got_shift, got_wkv = R.rwkv6_time_mix(
        p, torch.from_numpy(x), shift_state=t(shift), wkv_state=t(wkv),
        return_state=True, **KW)
    _close(got, want)
    _close(got_shift, want_shift)
    _close(got_wkv, want_wkv)
    assert got_wkv.dtype == torch.float32
    # without return_state: the output alone, the same
    _close(R.rwkv6_time_mix(p, torch.from_numpy(x), shift_state=t(shift),
                            wkv_state=t(wkv), **KW), want)


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(with_state):
    jp, p = _block(2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, D_MODEL)).astype(np.float32)
    shift = _states(rng, 2)[0] if with_state else None
    want, want_shift = JR.rwkv6_channel_mix(
        jp, jnp.asarray(x),
        shift_state=None if shift is None else jnp.asarray(shift),
        return_state=True)
    got, got_shift = R.rwkv6_channel_mix(
        p, torch.from_numpy(x),
        shift_state=None if shift is None else torch.from_numpy(shift),
        return_state=True)
    _close(got, want)
    _close(got_shift, want_shift)


def test_decode_steps_match_reference():
    """Both O(1) steps from random shift and WKV states."""
    jp, p = _block(3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, D_MODEL)).astype(np.float32)
    shift, wkv = _states(rng, 2)
    want, want_shift, want_wkv = JR.rwkv6_time_mix_step(
        jp, jnp.asarray(x), jnp.asarray(shift), jnp.asarray(wkv), **KW)
    got, got_shift, got_wkv = R.rwkv6_time_mix_step(
        p, torch.from_numpy(x), torch.from_numpy(shift),
        torch.from_numpy(wkv), **KW)
    _close(got, want)
    _close(got_shift, want_shift)
    _close(got_wkv, want_wkv)
    want, want_shift = JR.rwkv6_channel_mix_step(jp, jnp.asarray(x),
                                                 jnp.asarray(shift))
    got, got_shift = R.rwkv6_channel_mix_step(p, torch.from_numpy(x),
                                              torch.from_numpy(shift))
    _close(got, want)
    _close(got_shift, want_shift)


def test_time_mix_prefill_equals_decode_steps():
    """The chunked prefill over 20 tokens (ragged: padded to 32) equals
    20 decode steps from the same states, in the port alone."""
    _, p = _block(4)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 20, D_MODEL)).astype(
        np.float32))
    shift, wkv = map(torch.from_numpy, _states(rng, 2))
    out, _, final = R.rwkv6_time_mix(p, x, shift_state=shift,
                                     wkv_state=wkv, return_state=True, **KW)
    steps = []
    for t in range(x.shape[1]):
        o, shift, wkv = R.rwkv6_time_mix_step(p, x[:, t:t + 1], shift, wkv,
                                              **KW)
        steps.append(o)
    _close(out, torch.cat(steps, dim=1), 1e-4)
    _close(final, wkv, 1e-4)


# ---------------------------------------------------------------------------
# rwkv6-7b smoke: the RWKV6 stack
# ---------------------------------------------------------------------------


def test_init_params_shapes_dtypes_and_laws_match_reference():
    """Every parameter of the reference's pytree with its shape and dtype:
    the model's bf16, and f32 for decay_w0 and bonus_u; then the laws."""
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    assert cfg.dtype == "bfloat16"
    assert cfg.rwkv_heads == jcfg.rwkv_heads == 4
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
    blk = params.layers[0]
    m = blk.rwkv
    assert m.decay_w0.dtype == m.bonus_u.dtype == torch.float32
    for name in MUS:
        assert bool((getattr(m, name) == 0.5).all()), name
    assert bool((m.decay_w0 == -3).all()) and bool((m.bonus_u == 0).all())
    assert bool((m.ln_x_w == 1).all())
    assert bool((blk.ln1 == 1).all()) and bool((blk.ln2 == 1).all())
    for w in (m.w_r, m.w_o, m.decay_A, m.c_k, m.c_v):
        assert abs(w.float().std().item() * w.shape[0] ** 0.5 - 1) < 0.15
    cache = init_cache(cfg, 2, 16, "cpu")["layers"][0]
    assert cache["wkv"].shape == (2, 4, 16, 16)
    assert cache["wkv"].dtype == torch.float32
    assert cache["tm_shift"].shape == cache["cm_shift"].shape == (2, 1, 64)
    assert cache["tm_shift"].dtype == torch.bfloat16


def _run_both(jcfg, cfg, toks, max_len, n_decode):
    jparams, params = _model_params(jcfg, cfg)
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
    """Prefill logits over 32 tokens and the whole cache (WKV and shift
    states), then 4 decode steps."""
    jcfg, cfg = _cfgs()
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32 + 4)).astype(np.int32)
    _, pairs = _run_both(jcfg, cfg, toks, max_len=40, n_decode=4)
    for logits, jlogits, cache, jcache in pairs:
        assert tuple(logits.shape) == tuple(jlogits.shape)
        _close_scaled(logits, jlogits)
        got, want = _leaves(cache), _leaves(jcache)
        assert sorted(got) == sorted(want)
        for name in want:
            _close_scaled(got[name], want[name])


def test_cache_numpy_round_trip():
    """The reference's cache carried over: the WKV state stays f32 in a
    bf16 cache (rounding it would move every later token), the shift
    states take the model's dtype; decoding on from it matches JAX."""
    jcfg, cfg = _cfgs()
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jparams, params = _model_params(jcfg, cfg)
    _, jcache = _jprefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                          max_len=20)
    cache = cache_from_numpy(_np(jcache), "cpu", torch.bfloat16)
    assert cache["pos"] == 16 and len(cache["layers"]) == cfg.n_layers
    layer = cache["layers"][0]
    assert layer["wkv"].dtype == torch.float32
    assert layer["tm_shift"].dtype == layer["cm_shift"].dtype \
        == torch.bfloat16
    np.testing.assert_array_equal(layer["wkv"].numpy(),
                                  _np(jcache)["layers"]["wkv"][0])
    cache = cache_from_numpy(_np(jcache), "cpu")
    back, want = _leaves(cache_to_numpy(cache)), _leaves(jcache)
    assert sorted(back) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(back[name], want[name])
    tok = toks[:, -1:]
    jl, _ = _jdecode(jcfg, jparams, jcache, jnp.asarray(tok))
    logits, _ = decode_step(cfg, params, cache, torch.from_numpy(tok))
    _close(logits, jl)


def test_decode_matches_teacher_forcing():
    """Port of test_decode_matches_teacher_forcing[rwkv6-7b]: prefill +
    decode logits equal the full forward at the same positions."""
    jcfg, cfg = _cfgs()
    B, S, EXTRA = 2, 32, 4
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    params, pairs = _run_both(jcfg, cfg, toks, max_len=S + EXTRA,
                              n_decode=EXTRA)
    ref = forward_logits(cfg, params, torch.from_numpy(toks)).numpy()
    errs = [np.abs(logits[:, 0].numpy() - ref[:, S - 1 + t]).max()
            for t, (logits, _, _, _) in enumerate(pairs)]
    assert max(errs) < 1e-4, errs


def test_model_prefill_never_launches_on_cpu():
    """On CPU tensors every prefill WKV takes the plain version."""
    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = ops.launches
    toks = torch.zeros((1, 20), dtype=torch.int32)
    logits, cache = prefill(cfg, params, {"tokens": toks}, 24)
    assert ops.launches == before and cache["pos"] == 20
    assert bool(torch.isfinite(logits).all())


def test_serve_engine_matches_jax_engine():
    """The examples/serve_gcr.py setting on rwkv6 smoke, in f32 with the
    perturbed parameters: the same tokens as JaxServeEngine and GCR's 8
    fast / 2 parked admits."""
    jcfg, cfg = _cfgs()
    jparams, params = _model_params(jcfg, cfg, key=0)
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


def test_serve_launcher_runs_rwkv6_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--streams", "4",
                "--slots", "2", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-7b" in out and "device=cpu" in out
    assert "fast admits: 4" in out
