"""The port's MoE against ``repro.models.moe`` and the MoE models against
the JAX package, on the CPU.

Weights are the reference's own (``moe_params`` / ``init_params`` with
``jax.random``), carried over through numpy; inputs come from numpy.
Tolerances: 1e-5 for port vs JAX in f32 (sums taken in another order);
1e-4 for prefill + decode vs the full forward, as in the reference's
``test_decode_matches_teacher_forcing``.  Routing is compared exactly:
the same experts and the same admitted set, else the outputs could not
agree at all.
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
from repro.models import transformer as JT  # noqa: E402
from repro.models.moe import moe_mlp as jmoe_mlp  # noqa: E402
from repro.models.moe import moe_params as jmoe_params  # noqa: E402
from repro.serving.engine import JaxServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (decode_step, forward_logits,  # noqa: E402
                                init_params, prefill)
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import TorchServeEngine  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "mixtral-8x7b"]

# the reference's entry points, compiled once per config (eager JAX
# re-traces the layer scan at every call)
_jprefill = jax.jit(jprefill, static_argnums=(0,), static_argnames="max_len")
_jdecode = jax.jit(jdecode_step, static_argnums=(0,))
_jmoe_mlp = jax.jit(jmoe_mlp, static_argnames=(
    "n_experts", "top_k", "capacity_factor", "gcr_admission"))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _cfgs(arch, **over):
    over.setdefault("dtype", "float32")
    return (dataclasses.replace(jget_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


# ---------------------------------------------------------------------------
# moe_mlp alone
# ---------------------------------------------------------------------------


def _admitted_oracle(expert_idx, E, cap, offset):
    """Plain loop: walk each row's tokens in priority order, slot by slot,
    and admit a claim while its expert has room."""
    B, S, k = expert_idx.shape
    admitted = np.zeros((B, S, k), bool)
    for b in range(B):
        used = np.zeros(E, int)
        for i in range(S):
            s = (i + offset) % S
            for j in range(k):
                e = expert_idx[b, s, j]
                admitted[b, s, j] = used[e] < cap
                used[e] += 1
    return admitted


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
@pytest.mark.parametrize("offset", [None, 4099 * 3])
def test_moe_mlp_matches_reference(capacity_factor, offset):
    """f32: the same experts and admitted set, then the same output and
    aux, with drops (0.5) and without (8.0), rotated and not."""
    E, k, D, Fd, B, S = 8, 2, 32, 64, 2, 24
    jp = jmoe_params(jax.random.key(5), D, Fd, E, jnp.float32)
    p = M.MoE(D, Fd, E, device="cpu", dtype=torch.float32)
    for name, arr in _np(jp).items():
        getattr(p, name).copy_(torch.tensor(arr))
    x = np.random.default_rng(5).standard_normal((B, S, D)).astype(
        np.float32)
    tx = torch.from_numpy(x)
    kw = dict(n_experts=E, top_k=k, capacity_factor=capacity_factor,
              gcr_admission=True)

    # routing: experts exactly as jax.lax.top_k picks them
    _, _, _, expert_idx = M.router_topk(p.router, tx, k)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    np.testing.assert_array_equal(expert_idx.numpy(),
                                  np.asarray(jax.lax.top_k(jprobs, k)[1]))
    # admission: the port's ranks give the oracle's admitted set exactly,
    # and the reference drops exactly as many
    cap = M._capacity(S, E, k, capacity_factor)
    ranks = M.admission_ranks(expert_idx, E, offset)
    want_adm = _admitted_oracle(expert_idx.numpy(), E, cap, offset or 0)
    np.testing.assert_array_equal((ranks < cap).numpy(), want_adm)

    joff = None if offset is None else jnp.int32(offset)
    jout, jaux = _jmoe_mlp(jp, jnp.asarray(x), priority_offset=joff, **kw)
    out, aux = M.moe_mlp(p, tx, priority_offset=offset, **kw)
    drop = 1.0 - want_adm.mean()
    assert abs(float(jaux["moe_drop_frac"]) - drop) < 1e-6
    assert (drop > 0) == (capacity_factor < 1)
    _close(out, jout)
    assert set(aux) == set(jaux)
    for name in jaux:
        _close(aux[name], jaux[name])


def test_rotation_moves_the_drops_not_the_budget():
    """Port of test_moe_capacity_and_rotation's claim on one draw: another
    offset drops other tokens, about as many."""
    E, k, D, B, S = 4, 2, 16, 2, 32
    p = M.MoE(D, 32, E, device="cpu", dtype=torch.float32)
    M.moe_init_(p, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, S, D)).astype(np.float32))
    kw = dict(n_experts=E, top_k=k, capacity_factor=0.5, gcr_admission=True)
    out1, aux1 = M.moe_mlp(p, x, priority_offset=3, **kw)
    out2, aux2 = M.moe_mlp(p, x, priority_offset=3 + 7, **kw)
    assert bool(torch.isfinite(out1).all())
    assert 0.0 < float(aux1["moe_drop_frac"]) < 1.0
    assert abs(float(aux1["moe_drop_frac"])
               - float(aux2["moe_drop_frac"])) < 0.25
    assert not torch.equal(out1, out2)


def test_stack_aux_is_the_layer_mean_of_the_reference():
    jcfg, cfg = _cfgs("granite-moe-1b-a400m", moe_capacity_factor=0.5)
    jparams = jinit_params(jcfg, jax.random.key(1))
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jaux = jax.jit(lambda p, x: JT._stack(
        jcfg, p, x, jnp.arange(24), None, None, decode=False, cross_src=None,
        sc=JT._id_sc, remat=False, moe_offset=jnp.int32(5))[2])(
            jparams, jparams["embed"][jnp.asarray(toks)])
    x = params.embed[torch.from_numpy(toks)]
    _, _, aux = T._stack(cfg, params, x, torch.arange(24, dtype=torch.int32),
                         None, 0, decode=False, moe_offset=5)
    assert set(aux) == set(jaux) and float(jaux["moe_drop_frac"]) > 0
    for name in jaux:
        _close(aux[name], jaux[name])


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def test_init_params_shapes_dtypes_and_laws_match_reference():
    jcfg, cfg = jget_smoke(ARCHS[0]), get_smoke_config(ARCHS[0])
    jtree = jinit_params(jcfg, jax.random.key(0))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}
    names = set()
    for name, p in params.named_parameters():
        parts = name.split(".")
        key = "/".join(["layers"] + parts[2:] if parts[0] == "layers"
                       else parts)
        want = flat[key].shape[1:] if parts[0] == "layers" else \
            flat[key].shape
        assert tuple(p.shape) == tuple(want), name
        assert str(p.dtype).replace("torch.", "") == str(flat[key].dtype)
        names.add(key)
    assert names == set(flat)
    moe = params.layers[0].moe
    assert moe.router.dtype == torch.float32
    assert moe.wi_gate.dtype == torch.bfloat16
    # N(0, 1/in_dim) per expert matrix: in = d_model for wi, moe_d_ff for wo
    for w, fan_in in ((moe.router, cfg.d_model), (moe.wi_up, cfg.d_model),
                      (moe.wo, cfg.moe_d_ff)):
        assert abs(w.float().std().item() * fan_in ** 0.5 - 1.0) < 0.05


def test_router_stays_f32_in_a_bf16_model():
    """convert casts every array to its parameter's dtype: the experts to
    bf16, the router kept f32 and bit-exact."""
    jcfg, cfg = jget_smoke(ARCHS[0]), get_smoke_config(ARCHS[0])
    tree = _np(jinit_params(jcfg, jax.random.key(2)))
    params = params_from_numpy(tree, cfg, "cpu")
    for i, blk in enumerate(params.layers):
        assert blk.moe.router.dtype == torch.float32
        np.testing.assert_array_equal(blk.moe.router.numpy(),
                                      tree["layers"]["moe"]["router"][i])
        assert blk.moe.wo.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The models against the JAX package
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Default capacity factor (1.25): prefill drops tokens, as served."""
    jcfg, cfg = _cfgs(arch)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24 + 3)).astype(np.int32)
    _, pairs = _run_both(jcfg, cfg, toks, max_len=32, n_decode=3)
    for logits, jlogits, cache, jcache in pairs:
        assert tuple(logits.shape) == tuple(jlogits.shape)
        _close(logits, jlogits)
        assert int(cache["pos"]) == int(jcache["pos"])
        for name in ("k", "v"):
            _close(cache["layers"][name], jcache["layers"][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Port of test_decode_matches_teacher_forcing for the MoE archs, in
    the drop-free regime (capacity factor 8.0)."""
    jcfg, cfg = _cfgs(arch, moe_capacity_factor=8.0)
    B, S, EXTRA = 2, 24, 4
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    params, pairs = _run_both(jcfg, cfg, toks, max_len=S + EXTRA,
                              n_decode=EXTRA)
    ref = forward_logits(cfg, params, torch.from_numpy(toks)).numpy()
    errs = [np.abs(logits[:, 0].numpy() - ref[:, S - 1 + t]).max()
            for t, (logits, _, _, _) in enumerate(pairs)]
    assert max(errs) < 1e-4, errs
    for logits, jlogits, _, _ in pairs:
        _close(logits, jlogits)


def test_sliding_window_ring_buffer():
    """Port of test_sliding_window_ring_buffer (mixtral smoke, window 16):
    decode far past the window wraps the ring and keeps matching teacher
    forcing and the reference's decode."""
    jcfg, cfg = _cfgs("mixtral-8x7b", sliding_window=16,
                      moe_capacity_factor=8.0)
    B, S, EXTRA = 1, 24, 12
    toks = np.random.default_rng(4).integers(
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


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def test_engine_matches_jax_engine_on_granite():
    """Same tokens and the same GCR counts as JaxServeEngine, f32."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    jparams = jinit_params(jcfg, jax.random.key(0))
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 12)).astype(np.int32)
    jeng = JaxServeEngine(jcfg, jparams, n_slots=3, max_len=32,
                          admission_kind="gcr")
    eng = TorchServeEngine(cfg, params, n_slots=3, max_len=32,
                           admission_kind="gcr", device="cpu")
    want = jeng.generate(prompts, gen_len=6)
    got = eng.generate(prompts, gen_len=6)
    np.testing.assert_array_equal(got, want)
    assert (eng.admission.stat_fast, eng.admission.stat_parked) == (8, 2)
    assert (jeng.admission.stat_fast, jeng.admission.stat_parked) == (8, 2)


def test_serve_launcher_runs_granite_on_cpu(capsys):
    serve.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu",
                "--streams", "4", "--slots", "2", "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "arch=granite-moe-1b-a400m" in out and "device=cpu" in out
    assert "fast admits: 4" in out
