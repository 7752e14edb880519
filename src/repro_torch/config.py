"""Configuration: the port's own copy of ``repro.config``'s ``ModelConfig``,
``ShapeSpec``, ``SHAPES``, ``Cell``, ``cells_for``, ``OptimizerConfig``
and ``MeshConfig``, and the hardware model of the dry run.

Fields and defaults are copied field for field, so a configuration file
reads the same in both packages; so are the derived values
(``head_dim``, ``vocab_padded``, ``is_encdec``, ``subquadratic``,
``layer_kinds``, ``d_inner``, ``ssm_heads``, ``rwkv_heads``,
``param_count``, ``active_param_count``) and the cell rules.  The
reference's ``RuntimeConfig`` has no counterpart (the port reads no field
of it), and its TPU ``HardwareSpec`` is replaced by ``H100``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


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
    def subquadratic(self) -> bool:
        """True if long-context decode is feasible (assignment rule for
        long_500k: SSM / hybrid / sliding-window archs only)."""
        kinds = set(self.layer_kinds())
        if kinds <= {"mamba2", "rwkv6"}:
            return True
        if self.sliding_window > 0:
            return True
        if "mamba2" in kinds or "rwkv6" in kinds:
            return True   # hybrid: attention cache exists but SSM dominates
        return False

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

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

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_padded
        total = v * d                      # embedding
        total += v * d                     # lm head (untied)
        total += d                         # final norm
        hd = self.head_dim
        for kind in self.layer_kinds():
            if kind in ("attn", "moe"):
                attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                    + (self.n_heads * hd) * d
                if self.qk_norm:
                    attn += 2 * hd
                total += attn + 2 * d      # block norms
                if kind == "attn":
                    total += 3 * d * self.d_ff
                else:
                    total += self.n_experts * 3 * d * self.moe_d_ff \
                        + d * self.n_experts           # router
            elif kind == "mamba2":
                di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * ns + nh)    # in_proj (z,x,B,C,dt)
                total += (di + 2 * ns) * self.ssm_conv  # conv
                total += 2 * nh + di                   # A_log, D, dt_bias? (nh,nh,di gate norm)
                total += di * d                        # out_proj
                total += d                             # block norm
            elif kind == "rwkv6":
                total += 6 * d * d                     # r,k,v,w,g,out projections
                total += 2 * d * self.d_ff             # channel mix (k,v)...
                total += 8 * d                         # decay/bonus/mix params (approx)
                total += 2 * d                         # norms
        if self.shared_attn_every:
            hd2 = self.head_dim
            total += self.d_model * (self.n_heads * hd2) * 2 \
                + 2 * self.d_model * (self.n_kv_heads * hd2) \
                + 3 * self.d_model * self.d_ff + 2 * self.d_model
        if self.is_encdec:
            # encoder blocks (attn + mlp) + decoder cross-attn already counted
            enc = self.n_enc_layers * (
                4 * d * d + 3 * d * self.d_ff + 2 * d)
            cross = self.n_layers * (4 * d * d + d)
            total += enc + cross
        if self.frontend != "none":
            total += self.frontend_dim * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only active experts)."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.param_count()
        moe_layers = sum(1 for k in self.layer_kinds() if k == "moe")
        inactive = self.n_experts - self.n_experts_active
        total -= moe_layers * inactive * 3 * self.d_model * self.moe_d_ff
        return total


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
class Cell:
    arch: str
    shape: ShapeSpec

    @property
    def key(self) -> str:
        return f"{self.arch}/{self.shape.name}"


def cells_for(cfg: ModelConfig) -> List[ShapeSpec]:
    """Assignment skip rules (documented in DESIGN.md section 4):
    long_500k only for sub-quadratic archs; decode shapes for all archs
    here (every assigned arch has a decoder)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out


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


@dataclass(frozen=True)
class HardwareSpec:
    """One accelerator of a mesh, for the dry run's roofline."""
    name: str
    peak_flops: float        # dense bf16 FLOP/s
    hbm_bw: float            # bytes/s
    hbm_bytes: float
    nvlink_bw: float         # bytes/s each way, to a GPU of the same node
    gpus_per_node: int
    network_bw: float        # bytes/s each way, to a GPU of another node


# NVIDIA H100 SXM5 80 GB at its 700 W limit, data-sheet figures: dense
# bf16 tensor-core peak, HBM3 rate and size, NVLink 4 (900 GB/s both ways
# together), 8 GPUs a node as in a DGX H100, and one 400 Gb/s NDR
# InfiniBand port a GPU for traffic between nodes.
H100 = HardwareSpec(name="h100_sxm5_80gb", peak_flops=989e12,
                    hbm_bw=3.35e12, hbm_bytes=80e9, nvlink_bw=450e9,
                    gpus_per_node=8, network_bw=50e9)
