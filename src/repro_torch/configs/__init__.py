"""Config registry: one module per assigned architecture.

Each module exports ARCH (the exact published config) and SMOKE (a reduced
same-family config for CPU tests). `get_config(name, smoke=...)` resolves
by arch id.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "deepseek_v3_671b",
    "arctic_480b",
    "llama_3_2_vision_90b",
    "seamless_m4t_large_v2",
    "qwen3_8b",
    "granite_3_8b",
    "codeqwen1_5_7b",
    "mistral_nemo_12b",
    "rwkv6_3b",
    "recurrentgemma_2b",
]

# canonical dashed ids from the assignment
DASHED = {i.replace("_", "-"): i for i in ARCH_IDS}
DASHED.update({
    "deepseek-v3-671b": "deepseek_v3_671b",
    "arctic-480b": "arctic_480b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen3-8b": "qwen3_8b",
    "granite-3-8b": "granite_3_8b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
})


def get_config(name: str, smoke: bool = False):
    mod_name = DASHED.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.ARCH


def list_archs():
    return list(ARCH_IDS)
