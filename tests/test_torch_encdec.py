"""whisper-base (encoder-decoder, audio stub) and internvl2-2b (vision stub)
in the port against ``repro.models.transformer`` on the CPU.

Weights are the reference's own (``init_params`` with ``jax.random``),
carried over through numpy; tokens, frames and patches come from a seeded
numpy RNG, the stubs in the model's dtype as the reference's tests pass
them.  All in f32.  Tolerances, each stated where it is used:
* prefill and decode logits and every cache (the cross cache included)
  against the reference: 1e-5 (atol = rtol; sums in another order);
* prefill plus decode against the port's own full forward at the same
  positions: 1e-4, as the reference's ``test_decode_matches_teacher_forcing``;
* ``forward_train``'s loss 1e-5 relative, each gradient leaf 1e-4
  relative L2, at S = 64 and 1024, so that both of the reference's
  attention branches are held (its flash path needs S % 512 == 0 and
  T % 1024 == 0: at S = 1024 whisper's decoder self-attention takes it,
  its encoder and cross-attention (T = 512) do not; internvl2's 1024
  counts its patches);
* train steps: loss, grad_norm, lr and params 1e-5 (relative; L2 a leaf
  for the params), the AdamW moments 1e-4 relative L2 a leaf, the
  gradients' tolerance.  AdamW's first step moves each weight by about
  lr * sign(g), so a gradient element within summation noise of zero may
  move its weight the other way: after whisper's first step the params
  differ by 6.3e-6 (``layers.cross.wk``, whose gradient differs by
  1.4e-6), and the second step's gradients, and with them its moments, by
  1.2e-5.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import steps as jsteps  # noqa: E402
from repro.config import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.config import OptimizerConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,  # noqa: E402
                                 opt_state_to_numpy, params_from_numpy,
                                 params_to_numpy, params_to_tree)
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models import (Transformer, decode_step,  # noqa: E402
                                forward_logits, forward_train, init_params,
                                prefill)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.steps import make_train_step  # noqa: E402

ARCHS = ["whisper-base", "internvl2-2b"]


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_trees_close(got, want, tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    errs = {jax.tree_util.keystr(path): _rel_l2(g, w) for (path, g), w in
            zip(jax.tree_util.tree_leaves_with_path(got),
                jax.tree.leaves(want))}
    bad = {k: v for k, v in errs.items() if not v <= tol}
    assert not bad, bad


def _stubs(cfg, B, S, rng):
    """The frontend's inputs for S tokens: (B, n_patches, frontend_dim)
    patches or (B, S // enc_seq_divisor, frontend_dim) frames, f32."""
    out = {}
    if cfg.frontend == "vision_stub":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        out["frames"] = rng.standard_normal(
            (B, S // cfg.enc_seq_divisor, cfg.frontend_dim)).astype(
                np.float32)
    return out


def _train_batch(cfg, B, S_total, seed):
    """tokens and targets for S_total positions, the patches included."""
    rng = np.random.default_rng(seed)
    S = S_total - (cfg.n_patches if cfg.frontend == "vision_stub" else 0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            **_stubs(cfg, B, S_total, rng)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads_tree(cfg, grads):
    """The port's gradients (by parameter name) as the reference's tree."""
    holder = Transformer(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(grads[name])
    return params_to_numpy(holder)


def _loss_and_grads(cfg, params, batch, **kw):
    loss, metrics = forward_train(cfg, params, batch, **kw)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss, metrics, dict(zip(named, grads))


def _counting_flash():
    """Patches the flash op's dispatch to record each call's (causal,
    k_pos); returns the record and the undo."""
    calls, real = [], ops._forward

    def counting(q, k, v, q_pos, k_pos, window, causal, *rest):
        calls.append((causal, k_pos.clone()))
        return real(q, k, v, q_pos, k_pos, window, causal, *rest)

    ops._forward = counting

    def undo():
        ops._forward = real
    return calls, undo


# ---------------------------------------------------------------------------
# Parameters and caches across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """The port's init has the reference's names, shapes and dtypes, the
    encoder's layers, ``enc_norm``, ``frontend_proj`` and each decoder
    block's ``ln_cross`` and ``cross`` included, and the reference's
    laws: unit norms, N(0, 1/in) projections."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    jtree = jax.eval_shape(lambda k: jinit_params(jcfg, k),
                           jax.random.key(0))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       params_to_tree(params))
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jtree)
    assert got == want
    names = {name for name, _ in params.named_parameters()}
    if cfg.is_encdec:
        assert {"enc_norm", "enc_layers.0.attn.wq", "layers.0.ln_cross",
                "layers.0.cross.wo"} <= names
        assert not any(n.startswith("enc_layers.0.cross") for n in names)
        assert bool((params.enc_norm == 1).all())
        assert bool((params.layers[0].ln_cross == 1).all())
        w = params.layers[1].cross.wk.float()
        assert abs(w.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.1
    else:
        assert not any("cross" in n or "enc" in n for n in names)
    proj = params.frontend_proj.float()
    assert abs(proj.std().item() * cfg.frontend_dim ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_params_numpy_round_trip(arch):
    """The reference's weights in and out again, exactly: ``enc_layers``
    stacked on their layer axis, ``enc_norm``, ``frontend_proj``,
    ``ln_cross`` and ``cross``; a tree with an extra or a misshapen leaf
    raises."""
    jcfg, cfg = _cfgs(arch)
    tree = _np(jinit_params(jcfg, jax.random.key(1)))
    params = params_from_numpy(tree, cfg, "cpu")
    back = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)
    if cfg.is_encdec:
        np.testing.assert_array_equal(
            params.enc_layers[1].mlp.wo.numpy(),
            tree["enc_layers"]["mlp"]["wo"][1])
        np.testing.assert_array_equal(params.layers[1].cross.wv.numpy(),
                                      tree["layers"]["cross"]["wv"][1])
    bad = jax.tree.map(lambda a: a, tree)
    bad["frontend_proj"] = bad["frontend_proj"][:-1]
    with pytest.raises(ValueError, match="frontend_proj"):
        params_from_numpy(bad, cfg, "cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["enc_extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="enc_extra"):
        params_from_numpy(extra, cfg, "cpu")


def test_cross_cache_numpy_round_trip():
    """The reference's cache after a whisper prefill (its static cross
    cache (L, B, enc_len, n_kv, d_head) included) in and out again,
    exactly; decoding on from it gives the reference's logits (1e-5)."""
    jcfg, cfg = _cfgs("whisper-base")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    batch = {"tokens": toks[:, :10], **_stubs(cfg, 2, 10, rng)}
    jparams = jinit_params(jcfg, jax.random.key(1))
    _, jcache = jprefill(jcfg, jparams, _jax(batch), max_len=16)
    assert jcache["cross"]["k"].shape == (cfg.n_layers, 2, 5,
                                          cfg.n_kv_heads, cfg.head_dim)
    cache = cache_from_numpy(_np(jcache), "cpu")
    assert len(cache["cross"]) == cfg.n_layers
    assert tuple(cache["cross"][0]["k"].shape) == (2, 5, cfg.n_kv_heads,
                                                   cfg.head_dim)
    back = cache_to_numpy(cache)
    for part in ("layers", "cross"):
        for name in ("k", "v"):
            np.testing.assert_array_equal(back[part][name],
                                          np.asarray(jcache[part][name]))
    tok = toks[:, -1:]
    jl, _ = jdecode_step(jcfg, jparams, jcache, jnp.asarray(tok))
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    logits, _ = decode_step(cfg, params, cache, torch.from_numpy(tok))
    _close(logits, jl)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def _prompt(cfg, B, S, extra, seed):
    """Tokens for S + extra positions and the stubs of the whole run, as
    the reference's teacher-forcing test builds them: frames for all
    S + extra tokens, patches once."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + extra)).astype(np.int32)
    return toks, _stubs(cfg, B, S + extra, rng)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill of 24 tokens (after 8 patches, or with 14 frames) and 4
    decodes: logits, ``pos`` and every cache, the cross cache included,
    within 1e-5 of the reference's."""
    jcfg, cfg = _cfgs(arch)
    B, S, EXTRA = 2, 24, 4
    toks, stubs = _prompt(cfg, B, S, EXTRA, seed=3)
    off = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    max_len = S + EXTRA + off
    jparams = jinit_params(jcfg, jax.random.key(1))
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    batch = {"tokens": toks[:, :S], **stubs}
    jlogits, jcache = jprefill(jcfg, jparams, _jax(batch), max_len=max_len)
    logits, cache = prefill(cfg, params, _torch(batch), max_len)
    for t in range(EXTRA + 1):
        assert tuple(logits.shape) == tuple(jlogits.shape)
        _close(logits, jlogits)
        assert cache["pos"] == int(jcache["pos"]) == off + S + t
        got = cache_to_numpy(cache)
        assert sorted(got) == sorted(jcache)
        for part in ("layers", "cross"):
            if part in jcache:
                for name in ("k", "v"):
                    _close(got[part][name], jcache[part][name])
        if t == EXTRA:
            break
        tok = toks[:, S + t][:, None]
        jlogits, jcache = jdecode_step(jcfg, jparams, jcache,
                                       jnp.asarray(tok))
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Port of ``tests/test_models.py::test_decode_matches_teacher_forcing``
    for the two archs (B2, S24, EXTRA 4, f32): prefill plus 4 decodes give
    the full forward's logits at the same positions (1e-4); the patches
    shift every position by n_patches."""
    jcfg, cfg = _cfgs(arch)
    B, S, EXTRA = 2, 24, 4
    toks, stubs = _prompt(cfg, B, S, EXTRA, seed=2)
    off = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    params = params_from_numpy(_np(jinit_params(jcfg, jax.random.key(1))),
                               cfg, "cpu")
    ref = forward_logits(cfg, params, _torch({"tokens": toks, **stubs}))
    assert ref.shape[1] == off + S + EXTRA
    ref = ref.numpy()
    logits, cache = prefill(cfg, params,
                            _torch({"tokens": toks[:, :S], **stubs}),
                            max_len=S + EXTRA + off)
    errs = [np.abs(logits[:, 0].numpy() - ref[:, off + S - 1]).max()]
    for t in range(EXTRA):
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(toks[:, S + t][:, None]))
        errs.append(np.abs(logits[:, 0].numpy() - ref[:, off + S + t]).max())
    assert max(errs) < 1e-4, errs


def test_non_causal_attention_never_masks_a_whole_row():
    """Every non-causal flash call of a whisper prefill (the encoder's
    self-attention and the cross-attention) has key positions >= 0, so
    no row is fully masked and the kernel's zeros for such a row and the
    plain version's uniform average never differ; the causal calls are
    the decoder's self-attention.  3 calls a layer."""
    _, cfg = _cfgs("whisper-base")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks, stubs = _prompt(cfg, 2, 24, 0, seed=4)
    calls, undo = _counting_flash()
    try:
        prefill(cfg, params, _torch({"tokens": toks, **stubs}), 32)
    finally:
        undo()
    assert len(calls) == 2 * cfg.n_layers + cfg.n_enc_layers
    non_causal = [k_pos for causal, k_pos in calls if not causal]
    assert len(non_causal) == cfg.n_layers + cfg.n_enc_layers
    assert all(int(k_pos.min()) >= 0 for k_pos in non_causal)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [64, 1024],
                         ids=["plain_attention", "flash_branch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch, S):
    """f32, remat on, against ``jax.value_and_grad`` of the reference's
    ``forward_train``: the loss within 1e-5 relative, every gradient leaf
    (the encoder's, the cross-attention's and the frontend projection's
    included) within 1e-4 relative L2.  S counts internvl2's 8 patches,
    whose positions the loss masks out."""
    jcfg, cfg = _cfgs(arch)
    tree = _np(jinit_params(jcfg, jax.random.key(1)))
    params = params_from_numpy(tree, cfg, "cpu").requires_grad_(True)
    batch = _train_batch(cfg, 2, S, seed=4)
    (jloss, _), jgrads = jax.value_and_grad(
        jtransformer.forward_train, argnums=1, has_aux=True)(
            jcfg, jax.tree.map(jnp.asarray, tree), _jax(batch))
    loss, metrics, grads = _loss_and_grads(cfg, params, _torch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=0)
    assert metrics["loss"].item() == loss.item()
    _assert_trees_close(_grads_tree(cfg, grads), _np(jgrads), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_gradients_without_remat(arch):
    """With each layer (the encoder's too) recomputed in the backward
    pass, the loss and every gradient, the encoder's (reached through the
    cross-attention's K/V) included, equal those without remat (1e-6
    relative L2 a leaf; the same operations)."""
    _, cfg = _cfgs(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         "cpu").requires_grad_(True)
    batch = _torch(_train_batch(cfg, 2, 48, seed=6))
    out = {remat: _loss_and_grads(cfg, params, batch, remat=remat)
           for remat in (True, False)}
    assert out[True][0].item() == pytest.approx(out[False][0].item(),
                                                rel=1e-6)
    for name, g in out[False][2].items():
        assert g.abs().max() > 0, name
        assert _rel_l2(out[True][2][name], g) <= 1e-6, name


@pytest.mark.parametrize("arch,per_layer", [("whisper-base", 3),
                                            ("internvl2-2b", 1)])
def test_forward_train_launches_flash_each_attention_twice_under_remat(
        arch, per_layer):
    """Remat recomputes each layer, flash included: whisper's op runs 3
    times a layer a forward (the encoder's layer, the decoder's self- and
    cross-attention; the smoke config has as many encoder as decoder
    layers), twice that under remat; internvl2's once a layer.  Counted
    on the wrapper's plain path by patching its dispatch."""
    cfg = get_smoke_config(arch)
    assert cfg.n_enc_layers in (0, cfg.n_layers)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         "cpu").requires_grad_(True)
    batch = _torch(_train_batch(cfg, 1, 32, seed=5))
    calls, undo = _counting_flash()
    try:
        for remat, times in ((True, 2), (False, 1)):
            calls.clear()
            loss, _ = forward_train(cfg, params, batch, remat=remat)
            torch.autograd.grad(loss, list(params.parameters()))
            assert len(calls) == times * per_layer * cfg.n_layers, remat
    finally:
        undo()


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, microbatches):
    """Two steps of ``make_train_step`` (steps 0 and 1) from the
    reference's weights on the same batches, microbatching cutting the
    frames or patches with the tokens: loss, grad_norm, lr and params
    after each (1e-5 relative; L2 a leaf for the params), the AdamW
    moments (1e-4 relative L2 a leaf; see the module docstring) and the
    step count."""
    jcfg, cfg = _cfgs(arch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JOptimizerConfig(**kw),
                                           microbatches=microbatches))
    step = make_train_step(cfg, OptimizerConfig(**kw),
                           microbatches=microbatches)
    jparams = jinit_params(jcfg, jax.random.key(2))
    jopt = jadamw_init(jparams)
    params = params_from_numpy(_np(jparams), cfg, "cpu").requires_grad_(True)
    opt = adamw_init(params)
    for i in range(2):
        batch = _train_batch(cfg, 4, 64, seed=10 + i)
        jparams, jopt, jmetrics = jstep(jparams, jopt, _jax(batch),
                                        jnp.int32(i))
        params, opt, metrics = step(params, opt, _torch(batch), i)
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[name]),
                                       float(jmetrics[name]), rtol=1e-5,
                                       atol=0)
        _assert_trees_close(params_to_numpy(params), _np(jparams), 1e-5)
        got_opt = opt_state_to_numpy(opt, params)
        assert int(got_opt["count"]) == int(jopt["count"]) == i + 1
        for part in ("m", "v"):
            _assert_trees_close(got_opt[part], _np(jopt[part]), 1e-4)


def test_microbatches_cut_the_stubs_with_the_tokens():
    """``make_train_step`` with 2 microbatches hands ``forward_train``
    the two halves of every batch key, frames and patches with their
    tokens."""
    seen = []
    real = T.forward_train

    def recording(cfg, params, batch, **kw):
        seen.append({k: v.clone() for k, v in batch.items()})
        return real(cfg, params, batch, **kw)

    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             "cpu").requires_grad_(True)
        step = make_train_step(cfg, OptimizerConfig(warmup_steps=1,
                                                    total_steps=10),
                               microbatches=2)
        batch = _torch(_train_batch(cfg, 4, 32, seed=7))
        seen.clear()
        T.forward_train = recording
        try:
            step(params, adamw_init(params), batch, 0)
        finally:
            T.forward_train = real
        assert len(seen) == 2
        for j, part in enumerate(seen):
            assert sorted(part) == sorted(batch)
            for key, val in batch.items():
                assert torch.equal(part[key], val[2 * j:2 * j + 2]), key


# ---------------------------------------------------------------------------
# f32 frames in a bf16 model (a reference fault the port does not copy)
# ---------------------------------------------------------------------------


def _bf16_whisper_batch(cfg):
    batch = _train_batch(cfg, 2, 32, seed=8)
    assert batch["frames"].dtype == np.float32     # as the pipeline yields
    return batch


def test_f32_frames_train_and_prefill_a_bf16_whisper():
    """bf16 whisper-base smoke takes f32 frames, as ``SyntheticTokens``
    yields them: ``forward_train`` and ``prefill`` run and are finite,
    and the encoder's input is the frames' product in f32 cast to bf16,
    ``(frames.float() @ frontend_proj.float()).to(bfloat16)``."""
    cfg = get_smoke_config("whisper-base")
    assert cfg.dtype == "bfloat16"
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         "cpu").requires_grad_(True)
    batch = _torch(_bf16_whisper_batch(cfg))
    first = []
    real = T._enc_unit

    def recording(cfg_, p, x, *rest):
        if p is params.enc_layers[0]:
            first.append(x.detach().clone())
        return real(cfg_, p, x, *rest)

    T._enc_unit = recording
    try:
        loss, _ = forward_train(cfg, params, batch)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        with torch.no_grad():
            logits, cache = prefill(cfg, params, batch, 40)
    finally:
        T._enc_unit = real
    assert np.isfinite(loss.item())
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    assert cache["cross"][0]["k"].dtype == torch.bfloat16
    want = (batch["frames"].float()
            @ params.frontend_proj.detach().float()).to(torch.bfloat16)
    assert len(first) >= 2
    for x in first:
        assert x.dtype == torch.bfloat16 and torch.equal(x, want)


def test_reference_fails_on_f32_frames_in_a_bf16_whisper():
    """The reference on the same batch: its encoder's output is f32 (f32
    frames @ bf16 ``frontend_proj`` promotes), the cross-attention's
    residual promotes the decoder's layer-scan carry, and ``jax.lax.scan``
    raises ``TypeError``.  With the frames in bf16 it runs."""
    jcfg = jget_smoke("whisper-base")
    assert jcfg.dtype == "bfloat16"
    jparams = jinit_params(jcfg, jax.random.key(0))
    batch = _jax(_bf16_whisper_batch(jcfg))
    with pytest.raises(TypeError):
        jtransformer.forward_train(jcfg, jparams, batch)
    batch["frames"] = batch["frames"].astype(jnp.bfloat16)
    loss, _ = jtransformer.forward_train(jcfg, jparams, batch)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_each_arch_from_its_pipeline(arch, tmp_path):
    """``launch/train.py`` on each smoke config on the CPU: the prefetch
    pipeline's f32 frames or patches feed the bf16 model for 2 steps, the
    losses are finite, and the checkpoint holds the encoder's layers (or
    none) and the frontend's projection; a second run resumes at
    next_batch 2."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as launcher

    cfg = get_smoke_config(arch)
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--ckpt-every", "2", "--ckpt-dir",
            str(tmp_path)]
    losses = launcher.main(args + ["--steps", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    _, state, extra = CheckpointManager(str(tmp_path)).restore()
    params = state["params"]
    assert extra["next_batch"] == 2
    assert params["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    assert ("enc_layers" in params) == cfg.is_encdec
    if cfg.is_encdec:
        assert params["enc_layers"]["attn"]["wq"].shape[0] == \
            cfg.n_enc_layers
    assert len(launcher.main(args + ["--steps", "3"])) == 1
