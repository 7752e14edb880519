"""Configuration: the port's own copy of ``repro.config``'s ``ModelConfig``,
``ShapeSpec``, ``SHAPES``, ``OptimizerConfig`` and ``MeshConfig``.

Fields and defaults are copied field for field, so a configuration file
reads the same in both packages; only the derived values the port uses
(``head_dim``, ``vocab_padded``, ``is_encdec``, ``d_inner``,
``ssm_heads``, ``rwkv_heads``) are carried over.  The runtime and
hardware configs belong to later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 => attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ("attn",)   # cycled over layers

    # attention details
    d_head: int = 0                # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0        # 0 = full attention

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    gcr_moe: bool = False
    gcr_moe_rotate_every: int = 64

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_every: int = 0     # 0 = no shared block

    # RWKV6
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq_divisor: int = 1

    # modality frontend stub
    frontend: str = "none"         # none | audio_stub | vision_stub
    frontend_dim: int = 0
    n_patches: int = 0

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # ---- derived ---------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(1, self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 128 (lane width x model shards)."""
        return pad_to(self.vocab_size, 128)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    zero1: bool = True             # shard optimizer state over the data axis
    grad_compression: str = "none"  # none | int8  (cross-pod hop)


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    # single-pod: (data, model) = (16, 16); multi-pod adds pod=2 in front
    data: int = 16
    model: int = 16
    pods: int = 2

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.multi_pod \
            else (self.data, self.model)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod \
            else ("data", "model")

    @property
    def n_devices(self) -> int:
        n = self.data * self.model
        return n * self.pods if self.multi_pod else n
