"""Per-architecture configs: every arch of the reference, the decoders,
whisper-base's encoder-decoder and internvl2-2b's vision frontend.

``get_config(name)`` / ``get_smoke_config(name)`` / ``ARCHS`` keep the
reference's names.  An arch of ``ARCHS`` missing from ``PORTED`` would
raise ``NotImplementedError``; none is.  ``PORT_ONLY`` holds the
architectures the port runs and the reference does not (deepseek-v2-lite,
whose latent attention the reference lacks); ``get_config`` and
``get_smoke_config`` take them too.
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

PORT_ONLY: Dict[str, str] = {
    "deepseek-v2-lite": "deepseek_v2_lite",
}


def _mod(name: str):
    if name in PORT_ONLY:
        return import_module(f"repro_torch.configs.{PORT_ONLY[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{ARCHS + list(PORT_ONLY)}")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet; "
            f"ported: {sorted(PORTED)}")
    return import_module(f"repro_torch.configs.{PORTED[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _mod(name).SMOKE
