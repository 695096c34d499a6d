"""Architecture registry: --arch <id> resolves here."""
from .base import ModelConfig, ShapeSpec, SHAPES, shape_applicable, reduced

from . import (llama_3_2_vision_11b, internlm2_1_8b, command_r_35b,
               smollm_360m, command_r_plus_104b, mixtral_8x22b, grok_1_314b,
               rwkv6_7b, jamba_v0_1_52b, whisper_tiny, mistral_7b, llama3_70b)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    llama_3_2_vision_11b, internlm2_1_8b, command_r_35b, smollm_360m,
    command_r_plus_104b, mixtral_8x22b, grok_1_314b, rwkv6_7b,
    jamba_v0_1_52b, whisper_tiny, mistral_7b, llama3_70b)}

# the ten assigned architectures (the paper's own two are extras)
ASSIGNED = [
    "llama-3.2-vision-11b", "internlm2-1.8b", "command-r-35b",
    "smollm-360m", "command-r-plus-104b", "mixtral-8x22b", "grok-1-314b",
    "rwkv6-7b", "jamba-v0.1-52b", "whisper-tiny",
]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
