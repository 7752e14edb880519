"""Per-architecture configs: every arch of the reference, the decoders,
whisper-base's encoder-decoder and internvl2-2b's vision frontend.

``get_config(name)`` / ``get_smoke_config(name)`` / ``ARCHS`` keep the
reference's names.  An arch of ``ARCHS`` missing from ``PORTED`` would
raise ``NotImplementedError``; none is.
"""

from importlib import import_module
from typing import Dict, List

from ..config import ModelConfig

ARCHS: List[str] = [
    "zamba2-2.7b",
    "internlm2-20b",
    "deepseek-7b",
    "qwen3-0.6b",
    "qwen3-8b",
    "whisper-base",
    "rwkv6-7b",
    "internvl2-2b",
    "mixtral-8x7b",
    "granite-moe-1b-a400m",
]

PORTED: Dict[str, str] = {
    "zamba2-2.7b": "zamba2_2_7b",
    "internlm2-20b": "internlm2_20b",
    "deepseek-7b": "deepseek_7b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen3-8b": "qwen3_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "whisper-base": "whisper_base",
    "internvl2-2b": "internvl2_2b",
}


def _mod(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet; "
            f"ported: {sorted(PORTED)}")
    return import_module(f"repro_torch.configs.{PORTED[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _mod(name).SMOKE
