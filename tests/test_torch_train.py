"""The port's training path against the reference's, on the CPU.

Weights are the reference's own (``init_params`` with ``jax.random``),
carried over through numpy; inputs come from a seeded numpy RNG.  All in
f32.  Tolerances, each stated where it is used:
* the schedule and AdamW compute the reference's f32 arithmetic in the
  same order: 1e-6 relative, held per element for the schedule and the
  metrics and as the L2 of each leaf for AdamW's trees (its global norm
  sums the leaves in another order, which moves the clip factor, and with
  it every element, by an ulp);
* losses and the flash op take sums in another order (XLA against
  PyTorch's CPU kernels): losses 1e-5 relative, gradients 1e-4 relative L2
  a leaf, flash's dq, dk, dv and lse 1e-5 (atol = rtol);
* params and AdamW state after train steps: 1e-5 relative L2 a leaf;
* rwkv6's gradient leaves: 1e-4 of the leaf's largest value, with the
  RWKV6 parameters that the init sets to constants perturbed as in
  tests/test_torch_rwkv6.py.  At the init's constants the smoke model's
  gradients are ill-conditioned: the reference's own f32 gradients differ
  from the same computation in f64 by 4.3e-4 of the largest value (the
  channel mix and the embedding too, not only the WKV), so no f32
  computation holds 1e-4 there; perturbed, by 9e-5
  (``test_rwkv6_reference_gradients_are_ill_conditioned_at_init``);
* the autograd ops with ``impl="ref"`` against autograd through their
  plain versions: equal (the same operations); ``gradcheck`` in f64 at
  its default tolerances.
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
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import cosine_schedule as jcosine_schedule  # noqa: E402
from repro_torch.config import OptimizerConfig  # noqa: E402
from repro_torch.configs import PORTED, get_smoke_config  # noqa: E402
from repro_torch.convert import (load_numpy_,  # noqa: E402
                                 opt_state_to_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2_ssd.ref import ssd_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import wkv_ref  # noqa: E402
from repro_torch.models import Transformer, forward_train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               cosine_schedule)
from repro_torch.steps import (init_train_state,  # noqa: E402
                               make_decode_step, make_prefill,
                               make_train_step)

ARCH = "qwen3-0.6b"


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_trees_close(got, want, tol):
    """Same structure; every leaf within ``tol`` relative L2."""
    assert (jax.tree.structure(got) == jax.tree.structure(want))
    worst = {jax.tree_util.keystr(path): _rel_l2(g, w) for (path, g), w in
             zip(jax.tree_util.tree_leaves_with_path(got),
                 jax.tree.leaves(want))}
    bad = {k: v for k, v in worst.items() if not v <= tol}
    assert not bad, bad


# ---------------------------------------------------------------------------
# Schedule and AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 10, 55, 100])
def test_cosine_schedule_matches_reference(step):
    """Steps 0, the end of warmup, mid-decay and the end."""
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    got = cosine_schedule(step, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jcosine_schedule(step, **kw)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clip_hit", "no_clip"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_update_matches_reference(n_steps, clip):
    """A random tree of f32 and bf16 leaves; the gradients' global norm is
    about 2.3, so a grad_clip of 0.5 scales them and 100 does not."""
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (24,), "e": (3, 5, 4)}
    dtypes = {"w": jnp.float32, "b": jnp.bfloat16, "e": jnp.bfloat16}
    jparams = {k: jnp.asarray(rng.standard_normal(s), dtypes[k])
               for k, s in shapes.items()}
    params = {k: torch.tensor(np.asarray(v, np.float32)).to(
        getattr(torch, str(v.dtype))) for k, v in jparams.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jopt, opt = jadamw_init(jparams), adamw_init(params)
    for _ in range(n_steps):
        jgrads = {k: jnp.asarray(rng.standard_normal(s) * 0.3, dtypes[k])
                  for k, s in shapes.items()}
        grads = {k: torch.tensor(np.asarray(v, np.float32)).to(
            params[k].dtype) for k, v in jgrads.items()}
        jparams, jopt, jmetrics = jadamw_update(jgrads, jopt, jparams,
                                                JOptimizerConfig(**kw))
        params, opt, metrics = adamw_update(grads, opt, params,
                                            OptimizerConfig(**kw))
    assert (float(jmetrics["grad_norm"]) > clip) == (clip == 0.5)
    for k in shapes:
        assert params[k].dtype == getattr(torch, str(jparams[k].dtype))
        assert opt["m"][k].dtype == opt["v"][k].dtype == torch.float32
        for got, want in ((params[k], jparams[k]), (opt["m"][k],
                                                    jopt["m"][k]),
                          (opt["v"][k], jopt["v"][k])):
            assert _rel_l2(got.float().numpy(),
                           np.asarray(want, np.float32)) <= 1e-6, k
    assert int(opt["count"]) == int(jopt["count"]) == n_steps
    assert opt["count"].dtype == torch.int32
    for name in ("grad_norm", "lr"):
        assert metrics[name].dtype == torch.float32
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("S", [64, 1024], ids=["plain", "chunked"])
def test_softmax_xent_and_grads_match_jax(S, masked):
    """``chunked_softmax_xent`` (plain at S <= 512, chunked above) and its
    gradients in x and w; ``cross_entropy`` of the same logits."""
    rng = np.random.default_rng(1)
    B, D, V = 2, 32, 300
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = ((rng.random((B, S)) < 0.7).astype(np.float32) if masked
            else None)
    sc = lambda a, kind=None: a  # noqa: E731

    def jloss(x, w):
        return jlayers.chunked_softmax_xent(
            x, w, targets, None if mask is None else jnp.asarray(mask), sc)

    jval, (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(x, w)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    mt = None if mask is None else torch.from_numpy(mask)
    val = layers.chunked_softmax_xent(xt, wt, torch.from_numpy(targets), mt)
    dx, dw = torch.autograd.grad(val, (xt, wt))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5,
                               atol=0)
    assert _rel_l2(dx.numpy(), jdx) <= 1e-4
    assert _rel_l2(dw.numpy(), jdw) <= 1e-4

    logits = x @ w
    want = jlayers.cross_entropy(
        logits, targets, None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(targets), mt)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Flash attention under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 64])
def test_flash_autograd_matches_jax_custom_vjp(window):
    """The autograd op (plain forward with its lse, ``flash_bwd_ref``
    backward) against ``jax.grad`` of the reference's custom-VJP flash
    attention at S = T = 1024 (its flash branch), GQA 4/2 heads: the
    reference repeats K/V to 4 heads, so its dk, dv are summed over each
    group as the port's are.  Also the lse against ``_flash_fwd_impl``'s."""
    rng = np.random.default_rng(2)
    B, S, Hq, Hkv, D = 1, 1024, 4, 2, 16
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)

    def jfn(q, k, v):
        out = jlayers.flash_attention(q, jnp.repeat(k, 2, axis=2),
                                      jnp.repeat(v, 2, axis=2), pos, pos,
                                      window)
        return jnp.sum(out * dout)

    jgrads = jax.grad(jfn, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tpos = torch.from_numpy(pos)
    before = ops.launches
    out = ops.flash_attention_fwd(*leaves, tpos, tpos, window=window)
    assert out.grad_fn is not None and ops.launches == before  # plain, CPU
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    _, jlse = jlayers._flash_fwd_impl(
        jnp.asarray(q), jnp.repeat(k, 2, axis=2), jnp.repeat(v, 2, axis=2),
        jnp.asarray(pos), jnp.asarray(pos), window, True)
    _, lse = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), tpos,
                           tpos, window, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)


def test_flash_op_is_differentiable_only_when_asked():
    """No grad wanted: the plain output, no graph.  Grad wanted: the
    autograd op; ``return_lse`` also gives the rows' lse without a
    gradient; positions get none."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32)) for _ in range(3))
    pos = torch.arange(8, dtype=torch.int32)
    plain = ops.flash_attention_fwd(q, k, v, pos, pos)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_(True)
    out, lse = ops.flash_attention_fwd(qg, k, v, pos, pos, return_lse=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert not lse.requires_grad and lse.shape == (1, 2, 8)
    torch.testing.assert_close(out, plain)
    with torch.no_grad():
        assert ops.flash_attention_fwd(qg, k, v, pos, pos).grad_fn is None
    (dq,) = torch.autograd.grad(out.sum(), (qg,))
    assert dq.shape == q.shape


# ---------------------------------------------------------------------------
# The model's train forward and the train step
# ---------------------------------------------------------------------------


def _cfgs():
    return (dataclasses.replace(jget_smoke(ARCH), dtype="float32"),
            dataclasses.replace(get_smoke_config(ARCH), dtype="float32"))


def _batch(cfg, B, S, seed):
    """tokens and targets (B, S), and the frontend's f32 stub: patches
    (B, n_patches, frontend_dim) before them or frames (B, S //
    enc_seq_divisor, frontend_dim) for the encoder."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.standard_normal(
            (B, S // cfg.enc_seq_divisor, cfg.frontend_dim)).astype(
                np.float32)
    return batch


def _grads_tree(cfg, params, grads):
    """The port's gradients (by parameter name) as the reference's tree."""
    holder = Transformer(cfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(grads[name])
    return params_to_numpy(holder)


@pytest.mark.parametrize("S", [64, 1024],
                         ids=["plain_attention", "flash_branch"])
def test_forward_train_loss_and_grads_match_jax(S):
    """qwen3 smoke in f32, remat on: loss within 1e-5 relative, every
    gradient leaf within 1e-4 relative L2.  S = 64 is the reference's
    plain-attention branch, S = 1024 its custom-VJP flash branch (and the
    chunked LM-head loss); the port takes its one op at both."""
    jcfg, cfg = _cfgs()
    jparams = jinit_params(jcfg, jax.random.key(1))
    params = params_from_numpy(_np(jparams), cfg, "cpu").requires_grad_(True)
    batch = _batch(cfg, 2, S, seed=4)

    (jloss, _), jgrads = jax.value_and_grad(
        jtransformer.forward_train, argnums=1, has_aux=True)(
            jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = forward_train(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=0)
    assert metrics["loss"].item() == loss.item()
    _assert_trees_close(_grads_tree(cfg, params, grads), _np(jgrads), 1e-4)


def test_forward_train_launches_flash_twice_a_layer_under_remat():
    """Remat recomputes each block in the backward pass, flash included:
    two forward calls a layer a step (counted here on the wrapper's plain
    path by patching its dispatch), one without remat."""
    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         "cpu").requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 32, 5).items()}
    calls = []
    real = ops._forward

    def counting(*args):
        calls.append(1)
        return real(*args)

    ops._forward = counting
    try:
        for remat, want in ((True, 2), (False, 1)):
            calls.clear()
            loss, _ = forward_train(cfg, params, batch, remat=remat)
            torch.autograd.grad(loss, list(params.parameters()))
            assert len(calls) == want * cfg.n_layers
    finally:
        ops._forward = real


def _steps_match_reference(jcfg, cfg, microbatches, steps, seed):
    """``make_train_step`` from the reference's weights on the same
    batches, at the step indices ``steps``: after each, loss, grad_norm
    and lr, params and the AdamW state (m, v, count) against the
    reference's (1e-5 relative; L2 a leaf for the trees).  Returns the
    port's metrics of each step."""
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JOptimizerConfig(**kw),
                                           microbatches=microbatches))
    step = make_train_step(cfg, OptimizerConfig(**kw),
                           microbatches=microbatches)
    jparams = jinit_params(jcfg, jax.random.key(seed))
    jopt = jadamw_init(jparams)
    params = params_from_numpy(_np(jparams), cfg, "cpu").requires_grad_(True)
    opt = adamw_init(params)
    out = []
    for n, i in enumerate(steps):
        batch = _batch(cfg, 4, 64, seed=10 + n)
        jparams, jopt, jmetrics = jstep(
            jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.int32(i))
        params, opt, metrics = step(
            params, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
            i)
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[name]),
                                       float(jmetrics[name]), rtol=1e-5,
                                       atol=0)
        _assert_trees_close(params_to_numpy(params), _np(jparams), 1e-5)
        got_opt = opt_state_to_numpy(opt, params)
        assert got_opt["count"].dtype == np.int32
        assert int(got_opt["count"]) == int(jopt["count"]) == n + 1
        for part in ("m", "v"):
            _assert_trees_close(got_opt[part], _np(jopt[part]), 1e-5)
        out.append(metrics)
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Two steps of ``make_train_step`` (steps 0 and 1) against the
    reference's (``_steps_match_reference``)."""
    jcfg, cfg = _cfgs()
    _steps_match_reference(jcfg, cfg, microbatches, (0, 1), seed=2)


def test_serve_steps_of_a_train_state_match_reference():
    """``init_train_state`` turns grad on (f32 moments, int32 count); the
    prefill and decode steps built from ``make_prefill`` and
    ``make_decode_step`` run on such weights without recording a graph
    and give the reference's logits (1e-5)."""
    jcfg, cfg = _cfgs()
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    assert all(p.requires_grad for p in params.parameters())
    assert int(opt["count"]) == 0 and opt["count"].dtype == torch.int32
    assert all(m.dtype == torch.float32 and not m.any()
               for m in opt["m"].values())
    jparams = jinit_params(jcfg, jax.random.key(3))
    load_numpy_(params, _np(jparams))
    toks = _batch(cfg, 2, 14, seed=7)["tokens"]
    jlogits, jcache = jsteps.make_prefill(jcfg, 16)(
        jparams, {"tokens": jnp.asarray(toks[:, :12])})
    logits, cache = make_prefill(cfg, 16)(
        params, {"tokens": torch.from_numpy(toks[:, :12])})
    pairs = [(logits, jlogits)]
    jdecode, decode = jsteps.make_decode_step(jcfg), make_decode_step(cfg)
    for t in (12, 13):
        tok = toks[:, t:t + 1]
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        logits, cache = decode(params, cache, torch.from_numpy(tok))
        pairs.append((logits, jlogits))
    for got, want in pairs:
        assert got.grad_fn is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# The other decoder kinds: MoE (gmm), Mamba2 (ssd), RWKV6 (wkv)
# ---------------------------------------------------------------------------

KINDS = ["granite-moe-1b-a400m", "mixtral-8x7b", "zamba2-2.7b", "rwkv6-7b",
         "deepseek-7b", "internlm2-20b", "qwen3-8b"]
RWKV_MUS = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr")


def _kind_cfgs(arch):
    return (dataclasses.replace(jget_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _ref_weights(jcfg, key):
    """The reference's weights as numpy; for rwkv6 with the RWKV6
    parameters that the init sets to constants perturbed as
    tests/test_torch_rwkv6.py perturbs them (see the module docstring)."""
    tree = _np(jinit_params(jcfg, jax.random.key(key)))
    if "rwkv" in tree["layers"]:
        p, rng = tree["layers"]["rwkv"], np.random.default_rng(0)
        for name in RWKV_MUS:
            p[name] = rng.uniform(0.0, 1.0, p[name].shape).astype(np.float32)
        for name, draw in (("bonus_u", lambda s: rng.normal(0.0, 0.5, s)),
                           ("decay_w0", lambda s: rng.uniform(-6, -1, s)),
                           ("ln_x_w",
                            lambda s: 1.0 + rng.normal(0.0, 0.1, s))):
            p[name] = draw(p[name].shape).astype(np.float32)
    return tree


def _max_scaled(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("S", [64, 1024],
                         ids=["plain_attention", "flash_branch"])
@pytest.mark.parametrize("arch", KINDS)
def test_forward_train_of_every_decoder_kind_matches_jax(arch, S):
    """Every other ported decoder in f32, remat on, against
    ``jax.value_and_grad`` of the reference's ``forward_train``: the loss
    and each aux metric within 1e-5 relative, every gradient leaf within
    1e-4 (relative L2; rwkv6 relative to the leaf's largest value).  S =
    64 is the reference's plain-attention branch (and its one-chunk SSD),
    S = 1024 its custom-VJP flash branch (and four SSD chunks); the port
    takes its ops at both.  The MoE gradients reach the router through
    the gates, the probabilities and the aux losses; zamba2's shared
    block sums its gradients over its uses."""
    jcfg, cfg = _kind_cfgs(arch)
    tree = _ref_weights(jcfg, 1)
    params = params_from_numpy(tree, cfg, "cpu").requires_grad_(True)
    batch = _batch(cfg, 2, S, seed=4)

    (jloss, jmetrics), jgrads = jax.value_and_grad(
        jtransformer.forward_train, argnums=1, has_aux=True)(
            jcfg, jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = forward_train(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=0)
    assert sorted(metrics) == sorted(jmetrics)
    for name, val in metrics.items():
        np.testing.assert_allclose(val.item(), float(jmetrics[name]),
                                   rtol=1e-5, atol=1e-7)
    got, want = _grads_tree(cfg, params, grads), _np(jgrads)
    if arch == "rwkv6-7b":
        errs = {jax.tree_util.keystr(path): _max_scaled(g, w) for
                (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                    jax.tree.leaves(want))}
        assert max(errs.values()) <= 1e-4, errs
    else:
        _assert_trees_close(got, want, 1e-4)


def _op_case(op, dtype, rng):
    """(call, inputs, grad outputs): small inputs of one op, made with
    numpy, as leaves that require grad, and cotangents for each output."""
    def t(*shape, scale=1.0, fn=None):
        a = rng.standard_normal(shape) * scale
        a = fn(a) if fn else a
        return torch.tensor(a, dtype=dtype, requires_grad=True)

    if op == "gmm":
        x, w = t(2, 3, 5, 8), t(3, 8, 16, scale=0.3)
        return gmm_ops.grouped_matmul, (x, w), (t(2, 3, 5, 16),)
    if op == "ssd":
        B, S, H, P, N = 1, 20, 2, 4, 4
        xdt, Bm, Cm = t(B, S, H, P), t(B, S, N), t(B, S, N)
        a = t(B, S, H, fn=lambda a: -np.abs(a) * 0.1)
        init = t(B, H, P, N)
        return ssd_ops.ssd, (xdt, a, Bm, Cm, init), (t(B, S, H, P),
                                                     t(B, H, P, N))
    B, S, H, P = 1, 20, 2, 4
    r, k, v = t(B, S, H, P), t(B, S, H, P), t(B, S, H, P)
    w = t(B, S, H, P, fn=lambda a: np.exp(-np.exp(a * 0.5 - 2)))
    u, init = t(H, P, scale=0.5), t(B, H, P, P)
    return wkv_ops.wkv, (r, k, v, w, u, init), (t(B, S, H, P),
                                                t(B, H, P, P))


PLAIN = {"gmm": gmm_ref, "ssd": ssd_ref, "wkv": wkv_ref}
NODES = {"gmm": "GroupedMatmulBackward", "ssd": "SSDBackward",
         "wkv": "WKVBackward"}


@pytest.mark.parametrize("op", ["gmm", "ssd", "wkv"])
def test_autograd_op_matches_autograd_through_plain(op):
    """Each op with ``impl="ref"`` (its autograd Function: the plain
    forward, the plain backward) against autograd through the plain
    version directly, in f32 at small ragged shapes: outputs and every
    input's gradient equal, the state's cotangent included (ssd and wkv
    take and return a state).  Without grad, no graph."""
    fn, inputs, couts = _op_case(op, torch.float32,
                                 np.random.default_rng(20))
    outs = fn(*inputs, impl="ref")
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert type(outs[0].grad_fn).__name__ == NODES[op]
    grads = torch.autograd.grad(outs, inputs, couts)
    want_outs = PLAIN[op](*inputs)
    want_outs = (want_outs if isinstance(want_outs, tuple)
                 else (want_outs,))
    want = torch.autograd.grad(want_outs, inputs, couts)
    for got_t, want_t in zip(outs + grads, want_outs + want):
        assert got_t.dtype == want_t.dtype
        assert torch.equal(got_t, want_t)
    with torch.no_grad():
        plain = fn(*inputs)
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert all(t.grad_fn is None for t in plain)


@pytest.mark.parametrize("op", ["gmm", "ssd", "wkv"])
def test_autograd_op_gradcheck_f64(op):
    """``torch.autograd.gradcheck`` of each op (its plain forward and
    backward on the CPU) in f64 at tiny ragged shapes, every input and
    both outputs."""
    fn, inputs, _ = _op_case(op, torch.float64, np.random.default_rng(21))
    assert torch.autograd.gradcheck(lambda *a: fn(*a, impl="ref"), inputs)


def test_autograd_ops_take_a_dropped_state():
    """Training drops the final state: the ssd and wkv ops then get no
    cotangent for it, and give the gradients of y alone."""
    for op in ("ssd", "wkv"):
        fn, inputs, (dy, _) = _op_case(op, torch.float32,
                                       np.random.default_rng(22))
        y, _ = fn(*inputs)
        got = torch.autograd.grad(y, inputs, dy)
        y_plain, _ = PLAIN[op](*inputs)
        want = torch.autograd.grad(y_plain, inputs, dy)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("arch,per_layer", [
    ("granite-moe-1b-a400m", {"gmm": 3, "flash": 1}),
    ("zamba2-2.7b", {"ssd": 1}),
    ("rwkv6-7b", {"wkv": 1}),
])
def test_forward_train_launches_each_kernel_twice_a_layer_under_remat(
        arch, per_layer):
    """Remat recomputes each layer (and zamba2's shared block with the
    layer it follows) in the backward pass, its ops included: two forward
    calls of each op a layer, one without remat; the plain backwards of
    ssd and wkv replay the plain version, not the op.  Counted on the
    wrappers' plain path by patching their dispatch."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         "cpu").requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 32, 5).items()}
    mods = {"flash": ops, "gmm": gmm_ops, "ssd": ssd_ops, "wkv": wkv_ops}
    calls = dict.fromkeys(mods, 0)
    real = {name: mod._forward for name, mod in mods.items()}

    def counting(name):
        def fn(*args):
            calls[name] += 1
            return real[name](*args)
        return fn

    want = dict.fromkeys(mods, 0)
    for name, n in per_layer.items():
        want[name] = n * cfg.n_layers
    if cfg.shared_attn_every:
        want["flash"] = cfg.n_layers // cfg.shared_attn_every
    for name, mod in mods.items():
        mod._forward = counting(name)
    try:
        for remat, times in ((True, 2), (False, 1)):
            for name in calls:
                calls[name] = 0
            loss, _ = forward_train(cfg, params, batch, remat=remat)
            torch.autograd.grad(loss, list(params.parameters()))
            assert calls == {k: v * times for k, v in want.items()}, remat
    finally:
        for name, mod in mods.items():
            mod._forward = real[name]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_moe_train_step_matches_reference_across_a_rotation(microbatches):
    """granite-moe's smoke config in f32 (GCR-MoE on): ``make_train_step``
    at steps 0 and ``gcr_moe_rotate_every``, where the admission order's
    origin has moved by one stride, against the reference's, as
    ``test_train_step_matches_reference``.  A port that missed the
    rotation would differ from the second step on (drops: 17% of the
    smoke model's slots)."""
    jcfg, cfg = _kind_cfgs("granite-moe-1b-a400m")
    assert cfg.gcr_moe
    metrics = _steps_match_reference(
        jcfg, cfg, microbatches, (0, cfg.gcr_moe_rotate_every), seed=5)
    assert all(float(m["moe_drop_frac"]) > 0 for m in metrics)


def test_train_step_rotates_the_moe_priority_origin():
    """``make_train_step`` hands ``moe_mlp`` the offset (step //
    gcr_moe_rotate_every) * 4099 at every layer, in the forward and its
    recomputation."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    R = cfg.gcr_moe_rotate_every
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    step = make_train_step(cfg, OptimizerConfig(warmup_steps=1,
                                                 total_steps=10))
    seen = []
    real = moe_mod.moe_mlp

    def recording(*args, priority_offset=None, **kw):
        seen.append(priority_offset)
        return real(*args, priority_offset=priority_offset, **kw)

    moe_mod.moe_mlp = recording
    try:
        for i in (0, R - 1, R, 2 * R + 1):
            seen.clear()
            batch = {k: torch.from_numpy(v)
                     for k, v in _batch(cfg, 2, 16, seed=i).items()}
            params, opt, _ = step(params, opt, batch, i)
            assert seen == [(i // R) * 4099] * (2 * cfg.n_layers), i
    finally:
        moe_mod.moe_mlp = real


@pytest.mark.parametrize("arch", sorted(PORTED))
def test_smoke_train_step_shapes_and_finite(arch):
    """Port of the reference's test of the same name over the ported
    archs (all ten), in each smoke config's own dtype, the frontend's
    stub in it too: a forward without remat gives a finite loss, and the
    gradients under remat are finite, one for each parameter in its shape
    and dtype."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         "cpu").requires_grad_(True)
    dtype = getattr(torch, cfg.dtype)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 32, 8).items()}
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    loss, _ = forward_train(cfg, params, batch, remat=False)
    assert np.isfinite(loss.item())
    loss, _ = forward_train(cfg, params, batch, remat=True)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    for (name, p), g in zip(named.items(), grads):
        assert g.shape == p.shape and g.dtype == p.dtype, name
        assert bool(torch.isfinite(g.float()).all()), name


def test_rwkv6_reference_gradients_are_ill_conditioned_at_init():
    """Why the rwkv6 parity above perturbs the init's constants: at those
    constants the reference's own f32 gradients differ from the same
    computation in f64 by more than the 1e-4 the port is held to (about
    4.3e-4 of a leaf's largest value), so no f32 computation could meet
    it; perturbed, they differ by less (about 9e-5)."""
    jcfg, _ = _kind_cfgs("rwkv6-7b")
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg, 2, 64, 4).items()}

    def worst(tree):
        grads = {}
        for dtype in ("float32", "float64"):
            cfg = dataclasses.replace(jcfg, dtype=dtype)
            params = jax.tree.map(
                lambda a: jnp.asarray(a, getattr(jnp, dtype)), tree)
            grads[dtype] = jax.grad(
                lambda p: jtransformer.forward_train(cfg, p, batch)[0])(
                    params)
        return max(_max_scaled(g, w) for g, w in zip(
            jax.tree.leaves(grads["float32"]),
            jax.tree.leaves(grads["float64"])))

    with jax.enable_x64():
        at_init = worst(_np(jinit_params(jcfg, jax.random.key(1))))
        perturbed = worst(_ref_weights(jcfg, 1))
    assert at_init > 1e-4 > perturbed
