"""DeepSeek-V2's pieces in the port (a configuration of the port's own:
the JAX package has no latent attention), on the CPU in float32: the
absorbed decode against the expanded attention of one layer, YaRN's
frequencies and scale against values worked by hand from the published
formulas, the top-k gates without renormalising and the shared experts
counted once, the latent cache's leaves, and the published parameter
count.  The whole model against a plain float32 reference is
``bench/tests/test_bench_deepseek_v2.py``."""

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import ARCHS, PORT_ONLY, PORTED, get_config, \
    get_smoke_config
from repro_torch.models import init_params
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.transformer import (_yarn, cache_layout,
                                            forward_train, init_cache)

ARCH = "deepseek-v2-lite"


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _mla_kwargs(cfg):
    return dict(n_heads=cfg.n_heads, nope=cfg.qk_nope_head_dim,
                rope=cfg.qk_rope_head_dim, v_dim=cfg.v_head_dim,
                rope_theta=cfg.rope_theta, yarn=_yarn(cfg), eps=cfg.norm_eps)


def test_absorbed_decode_matches_expanded_attention():
    """A prompt of 12 through the expanded path fills the latent cache;
    3 decode steps through the absorbed path give, at each new position,
    what the expanded path gives over the whole sequence at once."""
    cfg = _f32(get_smoke_config(ARCH))
    gen = torch.Generator().manual_seed(0)
    blk = init_params(cfg, gen, "cpu").layers[0].attn
    with torch.no_grad():
        blk.kv_norm.copy_(1 + 0.1 * torch.randn(blk.kv_norm.shape,
                                                generator=gen))
    B, P, G = 2, 12, 3
    x = torch.randn((B, P + G, cfg.d_model), generator=gen)
    kw = _mla_kwargs(cfg)
    pos = torch.arange(P + G, dtype=torch.int32)
    with torch.no_grad():
        want, _ = L.mla_attention(blk, x, pos, None, 0, impl="ref", **kw)
        cache = init_cache(cfg, B, P + G, "cpu")["layers"][0]
        L.mla_attention(blk, x[:, :P], pos[:P], cache, 0, impl="ref", **kw)
        for t in range(P, P + G):
            got, _ = L.mla_attention(blk, x[:, t:t + 1], pos[t:t + 1],
                                     cache, t, decode=True, **kw)
            torch.testing.assert_close(got[:, 0], want[:, t], atol=1e-5,
                                       rtol=1e-5)


def test_yarn_frequencies_and_scale_worked_by_hand():
    """The published settings (rope dim 64, theta 10,000, factor 40,
    original 4,096, beta_fast 32, beta_slow 1, mscale = mscale_all_dim =
    0.707).  The ramp's ends: 64 ln(4096 / (32 x 2 pi)) / (2 ln 10^4) =
    10.47, floored to 10; 64 ln(4096 / (2 pi)) / (2 ln 10^4) = 22.51,
    ceiled to 23.  Below pair 10 the plain frequency 10^4^(-2i/64), from
    23 on that over 40, between them blended: at pair 16 by (16 - 10) /
    13, 0.01 x 7/13 + 0.00025 x 6/13 = 0.0055.  The softmax scale:
    192^-0.5 x (0.1 x 0.707 x ln 40 + 1)^2 = 192^-0.5 x 1.589627; cos and
    sin unscaled (mscale / mscale_all_dim = 1)."""
    assert L.yarn_correction_range(32, 1, 64, 1e4, 4096) == (10, 23)
    inv = L.yarn_frequencies(64, 1e4, 40.0, 4096, 32, 1)
    assert inv.shape == (32,) and inv.dtype == torch.float32
    for i in range(11):
        assert inv[i].item() == pytest.approx(1e4 ** (-2 * i / 64), rel=1e-6)
    for i in range(23, 32):
        assert inv[i].item() == pytest.approx(1e4 ** (-2 * i / 64) / 40,
                                              rel=1e-6)
    assert inv[16].item() == pytest.approx(0.0055, rel=1e-6)
    cos_scale, mult = L.mla_scales(_yarn(get_config(ARCH)))
    assert cos_scale == 1.0
    assert mult == pytest.approx(1.589627, abs=1e-6)
    assert mult / math.sqrt(192) == pytest.approx(0.114721, abs=1e-6)
    # no YaRN: plain frequencies, no scale
    assert L.mla_scales((0.0, 0, 32.0, 1.0, 1.0, 0.0)) == (1.0, 1.0)


def test_yarn_rope_takes_the_published_pair_order():
    """HF's DeepSeek-V2 rotates (x[0::2], x[1::2]) as two halves: a vector
    with only x[1] set moves into the second half's first dim, and at
    position 0 nothing rotates."""
    x = torch.zeros((1, 2, 1, 8))
    x[..., 1] = 1.0
    inv = L.yarn_frequencies(8, 1e4, 40.0, 16, 32, 1)
    out = L.yarn_rope(x, torch.tensor([0, 1]), inv, 1.0)
    assert out[0, 0, 0].tolist() == [0, 0, 0, 0, 1, 0, 0, 0]
    ang = inv[0].item()
    torch.testing.assert_close(out[0, 1, 0, [0, 4]],
                               torch.tensor([-math.sin(ang),
                                             math.cos(ang)]))


def test_top_k_gates_are_not_renormalised():
    gen = torch.Generator().manual_seed(1)
    router = torch.randn((16, 64), generator=gen)
    x = torch.randn((2, 5, 16), generator=gen)
    _, probs, gates, idx = MOE.router_topk(router, x, 6, renormalize=False)
    torch.testing.assert_close(gates, torch.gather(probs, -1, idx))
    assert (gates.sum(-1) < 1).all()
    _, _, renorm, _ = MOE.router_topk(router, x, 6)
    torch.testing.assert_close(renorm.sum(-1), torch.ones(2, 5))


def test_shared_experts_are_counted_once():
    """The MoE layer's output less the same layer's without its shared
    experts is their SwiGLU of every token, once."""
    cfg = _f32(get_smoke_config(ARCH))
    gen = torch.Generator().manual_seed(2)
    p = init_params(cfg, gen, "cpu").layers[0].moe
    x = torch.randn((2, 9, cfg.d_model), generator=gen)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.n_experts_active,
              capacity_factor=cfg.moe_capacity_factor, with_aux=False,
              renormalize=False)
    assert p.shared_wo.shape == (cfg.moe_shared_experts * cfg.moe_d_ff,
                                 cfg.d_model)
    with torch.no_grad():
        out, _ = MOE.moe_mlp(p, x, **kw)
        shared = (F.silu(x @ p.shared_wi_gate) * (x @ p.shared_wi_up)) \
            @ p.shared_wo
        del p.shared_wi_gate, p.shared_wi_up, p.shared_wo
        routed, _ = MOE.moe_mlp(p, x, **kw)
    torch.testing.assert_close(out - routed, shared, atol=1e-6, rtol=1e-6)


def test_latent_cache_leaves():
    """Each layer, the leading dense one first, holds the latent c_kv and
    the one rope key k_pe: 27 x 576 x 2 bytes a token at published
    widths, 8.9 x less than per-head keys and values of 192 and 128."""
    cfg = get_config(ARCH)
    layout = cache_layout(cfg, 4, 32_784)
    assert len(layout["layers"]) == 27
    for leaf in layout["layers"]:
        assert set(leaf) == {"c_kv", "k_pe"}
        assert tuple(leaf["c_kv"].shape) == (4, 32_784, 512)
        assert tuple(leaf["k_pe"].shape) == (4, 32_784, 64)
        assert leaf["c_kv"].dtype == leaf["k_pe"].dtype == torch.bfloat16
    per_token = 27 * (512 + 64) * 2
    assert per_token == 31_104
    assert 27 * 16 * (192 + 128) * 2 / per_token == pytest.approx(8.89,
                                                                  abs=0.01)
    smoke = get_smoke_config(ARCH)
    cache = init_cache(smoke, 2, 10, "cpu")
    assert [tuple(c["c_kv"].shape) for c in cache["layers"]] == \
        [(2, 10, 32)] * smoke.n_layers
    assert [tuple(c["k_pe"].shape) for c in cache["layers"]] == \
        [(2, 10, 8)] * smoke.n_layers


def test_published_parameter_count_and_registry():
    cfg = get_config(ARCH)
    assert cfg.param_count() == 15_706_484_224
    params = init_params(get_smoke_config(ARCH), torch.Generator(), "meta")
    assert sum(p.numel() for p in params.parameters()) == \
        get_smoke_config(ARCH).param_count()
    assert len(params.dense_layers) == 1 and len(params.layers) == 2
    assert ARCH in PORT_ONLY and ARCH not in ARCHS and ARCH not in PORTED
    assert len(ARCHS) == len(PORTED) == 10


def test_training_latent_attention_is_refused():
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, torch.Generator(), "cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long),
             "targets": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="latent attention"):
        forward_train(cfg, params, batch)
