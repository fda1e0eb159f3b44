"""Roofline terms of a counted step on one card: the port of
``src/repro/launch/hlo_analysis.py``.

Hardware model: one NVIDIA H100 SXM5 at its 700 W power limit, from
NVIDIA's data sheet (peaks, not measurements), per rank:
    compute_s    = bf16 FLOPs / 989e12 + float32 FLOPs / 67e12
                   (dense tensor-core bf16; float32 outside the tensor
                   cores, TF32 off as ``chip_smoke.py`` sets it)
    memory_s     = bytes / 3.35e12        (HBM3)
    collective_s = collective bytes / 50e9
The collective term is the rank's collectives' result bytes (the
reference's rule, ``op_count``) over one H100's link to other nodes: one
400 Gb/s NDR InfiniBand port a GPU, as in a DGX H100 (50e9 B/s a
direction).  Ranks are laid out row-major, eight to an NVLink node, so a
model group of 16 spans two nodes and the data and pod groups span nodes
too: no production axis stays within NVLink's 450e9 B/s a direction, and
every byte is charged the slower link.  One card (``--mesh host``) has no
collectives (``no_collectives``).  The port does run float32 products (the
MoE router, the flash backward's logits), so ``compute_s`` adds the two
dtypes' times.  The counts come from ``launch.op_count.analyze`` (the
reference parses compiled HLO).
"""
from __future__ import annotations

import dataclasses

from ..models.transformer import count_params  # noqa: F401  (re-exported)
from .op_count import COLLECTIVE_KINDS as _COLLECTIVES

# NVIDIA H100 SXM5, 700 W: data-sheet peaks
PEAK_FLOPS = 989e12          # bf16 / fp16 on the tensor cores, dense
PEAK_FLOPS_F32 = 67e12       # float32, no TF32
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # device memory
LINK_BW = 50e9               # bytes/s: one 400 Gb/s NDR port a GPU
CARD = "NVIDIA H100 SXM5 80GB, 700 W (data sheet)"

_TENSOR_CORE_DTYPES = ("bfloat16", "float16")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def no_collectives() -> CollectiveStats:
    """The reference's five kinds, all zero: one card has no collectives."""
    return CollectiveStats(bytes_by_kind={k: 0 for k in _COLLECTIVES},
                           count_by_kind={k: 0 for k in _COLLECTIVES})


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll: CollectiveStats
    chips: int
    attn_bytes: float = 0.0      # counted bytes inside attn_core scopes
    flash_io_bytes: float = 0.0  # kernel I/O replacing them on the flash path
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        by = self.flops_by_dtype or {"bfloat16": self.flops}
        return sum(f / (PEAK_FLOPS if dt in _TENSOR_CORE_DTYPES
                        else PEAK_FLOPS_F32) for dt, f in by.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def flash_bytes(self) -> float:
        """Bytes with the materialised attention chain (and the SSD chunk
        intermediates) replaced by the CUDA kernels' I/O: the kernel path.
        A step with no kernel I/O (the decode: its attention is the
        materialised softmax on the card too) keeps its counted bytes,
        where the reference's drops them."""
        if self.attn_bytes <= 0 or self.flash_io_bytes <= 0:
            return self.hbm_bytes
        return self.hbm_bytes - self.attn_bytes + self.flash_io_bytes

    @property
    def memory_s_flash(self) -> float:
        return self.flash_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll.total_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s_flash,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The binding term on the kernel path."""
        return max(self.compute_s, self.memory_s_flash, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "hbm_bytes_per_device": self.hbm_bytes,
            "attn_bytes_per_device": self.attn_bytes,
            "flash_io_bytes_per_device": self.flash_io_bytes,
            "collective_bytes": self.coll.total_bytes,
            "collective_breakdown": self.coll.bytes_by_kind,
            "collective_counts": self.coll.count_by_kind,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_s_flash": self.memory_s_flash,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def roofline_from_cost(cost, chips: int = 1,
                       flash_io_bytes: float = 0.0) -> Roofline:
    """The roofline of an ``op_count.OpCost`` (the reference's
    ``roofline_from_compiled``), its collectives the count's."""
    return Roofline(flops=cost.flops, hbm_bytes=cost.bytes,
                    coll=CollectiveStats(dict(cost.coll_bytes),
                                         dict(cost.coll_counts)),
                    chips=chips,
                    attn_bytes=cost.attn_bytes,
                    flash_io_bytes=flash_io_bytes,
                    flops_by_dtype=dict(cost.flops_by_dtype))


def flash_attention_io_bytes(cfg, seq: int, batch: int, kind: str,
                             chips: int) -> float:
    """HBM I/O of the flash-attention and SSD kernels replacing the
    materialised chains, the reference's arithmetic unchanged:

      q = o = B·S·H·dh·2 bytes;  k = v = B·S·Hkv·dh·2 bytes
      prefill:  q + k + v + o                      = 2q + 2kv
      train:    fwd + remat-recompute fwd + bwd(q,k,v,o,dO reads;
                dq,dk,dv writes)                   ≈ 8q + 8kv
      decode:   no adjustment (the cache stream IS the traffic)

    SSD layers add their chunk-tile reads (x, B, C, dt) and y write."""
    if kind == "decode":
        return 0.0
    ssd_io = 0.0
    if cfg.ssd is not None:
        s = cfg.ssd
        per_layer = (2 * batch * seq * s.d_inner          # x read + y write
                     + 4 * batch * seq * s.d_state        # B, C (+grads rd)
                     + 2 * batch * seq * s.n_heads) * 2   # dt; bf16
        n_ssd = cfg.n_layers
        ssd_io = n_ssd * per_layer * (4 if kind == "train" else 1)
    if cfg.family == "ssm":
        return ssd_io / chips
    if cfg.attn_type == "mla" and cfg.mla is not None:
        h = cfg.mla.n_heads
        dh_q = cfg.mla.qk_nope + cfg.mla.qk_rope
        q = batch * seq * h * dh_q * 2
        kv_pair = batch * seq * h * (dh_q + cfg.mla.v_head) * 2  # expanded K+V
    else:
        h, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.hd
        q = batch * seq * h * dh * 2
        kv_pair = 2 * batch * seq * hkv * dh * 2
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(cfg.shared_every, 1)
    elif cfg.family == "encdec":
        n_attn = cfg.n_enc_layers + 2 * cfg.n_layers   # self+self+cross
    else:
        n_attn = cfg.n_layers
    per_layer_fwd = 2 * q + kv_pair
    if kind == "train":
        per_layer = 4 * per_layer_fwd          # fwd + recompute + bwd(≈2x)
    else:
        per_layer = per_layer_fwd
    return (n_attn * per_layer + ssd_io) / chips


def model_flops(n_params_active: float, tokens: float) -> float:
    """MODEL_FLOPS = 6·N·D (per step, dense) / 6·N_active·D (MoE)."""
    return 6.0 * n_params_active * tokens
