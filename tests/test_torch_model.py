"""The port's dense decoder against ``repro.models.transformer`` on the CPU.

Weights are the reference's own (``init_params`` with ``jax.random``),
carried over by ``convert.params_from_numpy``; tokens come from numpy.
Tolerances: 1e-5 for port vs JAX in f32 (sums taken in another order),
1e-4 for prefill+decode vs the full forward, as in the reference's
``test_decode_matches_teacher_forcing``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro_torch.configs import (ARCHS, PORTED, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.models import (decode_step, forward_logits,  # noqa: E402
                                init_params, prefill)

ARCH = "qwen3-0.6b"


def _cfgs(**over):
    over.setdefault("dtype", "float32")
    return (dataclasses.replace(jget_smoke(ARCH), **over),
            dataclasses.replace(get_smoke_config(ARCH), **over))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_configs_copied_field_for_field():
    """Every arch of the reference is ported (whisper-base and
    internvl2-2b last), each config and smoke config copied field for
    field, with the derived values the port reads."""
    assert sorted(PORTED) == sorted(ARCHS) == sorted(
        [ARCH, "granite-moe-1b-a400m", "mixtral-8x7b", "zamba2-2.7b",
         "rwkv6-7b", "deepseek-7b", "internlm2-20b", "qwen3-8b",
         "whisper-base", "internvl2-2b"])
    for arch in PORTED:
        for jcfg, cfg in ((jget_config(arch), get_config(arch)),
                          (jget_smoke(arch), get_smoke_config(arch))):
            for f in dataclasses.fields(jconfig.ModelConfig):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
            assert (cfg.head_dim, cfg.vocab_padded, cfg.rwkv_heads,
                    cfg.is_encdec) == (jcfg.head_dim, jcfg.vocab_padded,
                                       jcfg.rwkv_heads, jcfg.is_encdec)
    assert [a for a in ARCHS if get_config(a).is_encdec] == ["whisper-base"]
    with pytest.raises(KeyError):
        get_smoke_config("no-such-arch")


def test_init_params_shapes_dtypes_and_laws_match_reference():
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
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
    # the laws: N(0, 0.02) embedding, N(0, 1/in) dense, unit norms
    emb = params.embed.float()
    assert abs(emb.std().item() - 0.02) < 0.001
    head = params.lm_head.float()
    assert abs(head.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert bool((params.layers[0].ln1 == 1).all())


def _run_both(jcfg, cfg, toks, max_len, n_decode, key=1):
    jparams = jinit_params(jcfg, jax.random.key(key))
    params = params_from_numpy(_np_tree(jparams), cfg, "cpu")
    S = toks.shape[1] - n_decode
    jlogits, jcache = jprefill(jcfg, jparams, {"tokens": jnp.asarray(
        toks[:, :S])}, max_len=max_len)
    logits, cache = prefill(cfg, params,
                            {"tokens": torch.from_numpy(toks[:, :S])},
                            max_len)
    pairs = [(logits, jlogits, cache_to_numpy(cache), jcache)]
    for t in range(n_decode):
        tok = toks[:, S + t][:, None]
        jlogits, jcache = jdecode_step(jcfg, jparams, jcache,
                                       jnp.asarray(tok))
        logits, cache = decode_step(cfg, params, cache, torch.from_numpy(tok))
        pairs.append((logits, jlogits, cache_to_numpy(cache), jcache))
    return params, pairs


@pytest.mark.parametrize("window", [0, 16])
def test_prefill_and_decode_match_jax(window):
    jcfg, cfg = _cfgs(sliding_window=window)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24 + 3)).astype(np.int32)
    _, pairs = _run_both(jcfg, cfg, toks, max_len=32, n_decode=3)
    for logits, jlogits, cache, jcache in pairs:
        assert tuple(logits.shape) == tuple(jlogits.shape)
        _close(logits, jlogits)
        assert int(cache["pos"]) == int(jcache["pos"])
        for name in ("k", "v"):
            _close(cache["layers"][name], jcache["layers"][name])


def test_cache_numpy_round_trip():
    jcfg, cfg = _cfgs()
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jparams = jinit_params(jcfg, jax.random.key(1))
    _, jcache = jprefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                         max_len=16)
    cache = cache_from_numpy(_np_tree(jcache), "cpu")
    assert cache["pos"] == 10 and len(cache["layers"]) == cfg.n_layers
    back = cache_to_numpy(cache)
    for name in ("k", "v"):
        np.testing.assert_array_equal(back["layers"][name],
                                      np.asarray(jcache["layers"][name]))
    # decoding on from the carried-over cache matches the reference
    tok = toks[:, -1:]
    jl, _ = jdecode_step(jcfg, jparams, jcache, jnp.asarray(tok))
    params = params_from_numpy(_np_tree(jparams), cfg, "cpu")
    logits, _ = decode_step(cfg, params, cache, torch.from_numpy(tok))
    _close(logits, jl)


def test_decode_matches_teacher_forcing():
    """Port of test_decode_matches_teacher_forcing[qwen3-0.6b]: prefill +
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


def test_sliding_window_ring_buffer():
    """Port of test_sliding_window_ring_buffer on qwen3 smoke with
    sliding_window=16: decode far past the window wraps the ring and
    keeps matching teacher forcing (and the reference's decode)."""
    jcfg, cfg = _cfgs(sliding_window=16)
    B, S, EXTRA = 1, 24, 12
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    params, pairs = _run_both(jcfg, cfg, toks, max_len=S + EXTRA,
                              n_decode=EXTRA, key=3)
    assert pairs[0][2]["layers"]["k"].shape[2] == 16     # ring of 16 slots
    ref = forward_logits(cfg, params, torch.from_numpy(toks)).numpy()
    errs = []
    for t, (logits, jlogits, _, _) in enumerate(pairs[1:]):
        errs.append(np.abs(logits[:, 0].numpy() - ref[:, S + t]).max())
        _close(logits, jlogits)
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("arch", ["deepseek-7b", "internlm2-20b",
                                  "qwen3-8b"])
def test_dense_configs_prefill_decode_match_jax(arch, window):
    """The three other dense configs (MHA 4/4, GQA 4/2 without QK norm,
    qwen3-8b's GQA with QK norm) in f32: prefill and 4 decodes against the
    reference (1e-5, logits and caches) and against the full forward at
    the same positions (1e-4, teacher forcing)."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32",
                               sliding_window=window)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              sliding_window=window)
    B, S, EXTRA = 2, 24, 4
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    params, pairs = _run_both(jcfg, cfg, toks, max_len=S + EXTRA,
                              n_decode=EXTRA)
    for logits, jlogits, cache, jcache in pairs:
        _close(logits, jlogits)
        for name in ("k", "v"):
            _close(cache["layers"][name], jcache["layers"][name])
    ref = forward_logits(cfg, params, torch.from_numpy(toks)).numpy()
    errs = [np.abs(logits[:, 0].numpy() - ref[:, S - 1 + t]).max()
            for t, (logits, _, _, _) in enumerate(pairs)]
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_decode(arch):
    """Port of ``tests/test_models.py::test_smoke_prefill_decode`` over all
    ten archs, each smoke config in its own dtype, the frontend's stub in
    it too: a prefill of 32 tokens gives (B, 1, V) logits, and a greedy
    decode step after it finite (B, 1, V) logits."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 32
    rng = np.random.default_rng(0)
    dtype = getattr(torch, cfg.dtype)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.frontend_dim))).to(dtype)
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S // cfg.enc_seq_divisor, cfg.frontend_dim))).to(dtype)
    logits, cache = prefill(cfg, params, batch, max_len=S + 8)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_padded)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    logits2, cache = decode_step(cfg, params, cache, tok)
    assert tuple(logits2.shape) == (B, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(logits2.float()).all())
