"""deepseek-v2-lite [moe]: latent attention (MLA), one leading dense
layer, 64 routed experts top-6 with gates not renormalised and 2 shared
experts, YaRN rope [arXiv:2405.04434; huggingface.co/deepseek-ai/
DeepSeek-V2-Lite config.json].  27L d_model=2048 16H, q 2048 -> 16 x
(128 + 64) (no q_lora_rank), kv 2048 -> 512 + 64, kv_b 512 -> 16 x
(128 + 128), dense d_ff=10944, expert d_ff=1408, vocab=102400.

A port-only configuration: the reference package has no latent
attention, so it is not in ``ARCHS``.  The capacity factor 1.25 (GCR
admission, as mixtral's) is assumed; the published model drops no
token."""

import dataclasses

from ..config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    block_pattern=("moe",),
    d_head=192,
    rope_theta=10000.0,
    n_experts=64,
    n_experts_active=6,
    moe_d_ff=1408,
    moe_capacity_factor=1.25,
    norm_eps=1e-6,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_dense_layers=1,
    moe_shared_experts=2,
    moe_renormalize=False,
    yarn_factor=40.0,
    yarn_original_max_len=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, d_head=24, n_experts=8, n_experts_active=3,
    moe_d_ff=32, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, yarn_original_max_len=16)
