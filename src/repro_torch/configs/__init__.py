"""Architecture registry of the port: ``get(name)`` -> ArchConfig,
``smoke(name)`` -> the reduced same-family config the CPU tests run.

The port holds the configs of the families it serves (dense, moe with GQA
or latent attention, ssm, hybrid); ``ARCH_IDS`` names every assigned
architecture, and ``get`` of one whose config is not ported yet (the
``encdec`` and ``vlm`` families) raises ``NotImplementedError`` (ROADMAP
A.11e).

Shape cells (LM grid):
  train_4k      seq 4096,    global_batch 256   (train_step)
  prefill_32k   seq 32768,   global_batch 32    (serve prefill)
  decode_32k    seq 32768,   global_batch 128   (serve_step: 1 new token)
  long_500k     seq 524288,  global_batch 1     (sub-quadratic archs only)
"""
from __future__ import annotations

import importlib

from ..models.transformer import ArchConfig

ARCH_IDS = [
    "seamless_m4t_medium",
    "deepseek_v2_lite_16b",
    "olmoe_1b_7b",
    "phi3_medium_14b",
    "mistral_nemo_12b",
    "qwen15_4b",
    "internlm2_1_8b",
    "zamba2_2_7b",
    "mamba2_780m",
    "llava_next_34b",
]
PORTED = ("deepseek_v2_lite_16b", "olmoe_1b_7b", "phi3_medium_14b",
          "mistral_nemo_12b", "qwen15_4b", "internlm2_1_8b", "zamba2_2_7b",
          "mamba2_780m")

# canonical shape grid
SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    name = canonical(name)
    if name not in PORTED:
        raise NotImplementedError(
            f"{name}: config not ported yet (the port holds {PORTED}; "
            "ROADMAP A.11e)" if name in ARCH_IDS else f"unknown arch {name}")
    return importlib.import_module(f".{name}", __package__)


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
