"""Architecture registry of the port: ``get(name)`` -> ArchConfig,
``smoke(name)`` -> the reduced same-family config the CPU tests run,
``input_specs(...)`` -> ``meta`` tensors (shape and dtype, no storage;
the reference's ``ShapeDtypeStruct``) for every model input of a shape
cell.  The port holds every assigned architecture's config (``ARCH_IDS``),
of all six families.

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
PORTED = tuple(ARCH_IDS)

# canonical shape grid
SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

# archs allowed to run long_500k (sub-quadratic decode state)
SUBQUADRATIC = {"zamba2_2_7b", "mamba2_780m"}


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    name = canonical(name)
    if name not in PORTED:
        raise ValueError(f"unknown arch {name}")
    return importlib.import_module(f".{name}", __package__)


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    arch = canonical(arch)
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("full-attention arch: 500k-key dense attention decode "
                       "is the quadratic regime the brief excludes (DESIGN.md)")
    return True, ""


def input_specs(cfg: ArchConfig, shape: str):
    """``meta`` tensors for every model input (+ cache for decode): the
    stub frontends' ``enc_embeds`` (B, S, d_model) and ``patch_embeds``
    (B, n_patches, d_model) in bf16.

    Returns (batch_dict, kind) where kind in {train, prefill, decode}."""
    import torch
    from ..models.transformer import init_cache_abstract

    info = SHAPES[shape]
    s, b, kind = info["seq"], info["batch"], info["kind"]

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if kind in ("train", "prefill"):
        batch = {"tokens": spec((b, s), torch.int32)}
        if kind == "train":
            batch["labels"] = spec((b, s), torch.int32)
        if cfg.family == "encdec":
            batch["enc_embeds"] = spec((b, s, cfg.d_model), torch.bfloat16)
        if cfg.family == "vlm":
            batch["patch_embeds"] = spec((b, cfg.n_patches, cfg.d_model),
                                         torch.bfloat16)
        return batch, kind

    # decode: one new token against a seq-length cache
    batch = {"tokens": spec((b, 1), torch.int32),
             "cache": init_cache_abstract(cfg, b, s)}
    return batch, kind
