"""Plain oracles for the kernels, torch twins of the JAX package's
``kernels/ref.py``: the tests hold the kernels and the wave engine against
these."""
from __future__ import annotations

import numpy as np
import torch


def gather_rows_ref(data: torch.Tensor, rids: torch.Tensor) -> torch.Tensor:
    return data[rids.long()]


def gather_batched_ref(data, rlists):
    """NumPy oracle for checkout_batched: per-version gather loop."""
    data = data.cpu().numpy() if isinstance(data, torch.Tensor) \
        else np.asarray(data)
    return [data[np.asarray(rl, dtype=np.int64)] for rl in rlists]


def gather_row_tiles_ref(data: torch.Tensor, tile_idx: torch.Tensor,
                         block_n: int) -> torch.Tensor:
    r, d = data.shape
    tiles = data.reshape(r // block_n, block_n, d)
    return tiles[tile_idx.long()].reshape(-1, d)


def membership_scan_ref(bitmap: torch.Tensor, vid: int, block_r: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """R a multiple of block_r, as in the reference oracle.  The words are
    read as int32 (torch shifts no uint32): ``(x >> b) & 1`` is the same
    bit under the arithmetic shift."""
    word, bit = vid // 32, vid % 32
    words = bitmap.view(torch.int32)
    mask = ((words[:, word] >> bit) & 1).to(torch.int32)
    cnt = mask.reshape(-1, block_r).sum(dim=1, dtype=torch.int32)
    return mask, cnt


def version_aggregate_ref(bitmap: torch.Tensor,
                          values: torch.Tensor) -> torch.Tensor:
    r, w = bitmap.shape
    shifts = torch.arange(32, dtype=torch.int32)
    bits = (bitmap.view(torch.int32)[:, :, None] >> shifts) & 1   # (R, W, 32)
    out = torch.einsum("rwb,r->wb", bits.to(torch.float32),
                       values.to(torch.float32))
    return out.reshape(w * 32)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Materialised-softmax GQA attention oracle for flash_attention, with
    the reference's rounding: the probabilities are cast to q's dtype
    before ``p·v``.  q: (B,Sq,H,Dh); k: (B,Sk,Hkv,Dh); v: (B,Sk,Hkv,Dv),
    Dv = Dh but for latent attention's narrower values; query i sits at
    position ``q_offset + i`` (the model's decode step against its cache)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * dh ** -0.5
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        m = torch.arange(k.shape[1], device=q.device)[None, :] <= qpos[:, None]
        logits = torch.where(m[None, None, None], logits, -1e30)
    p = torch.softmax(logits, -1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, sq, h, v.shape[-1])


def ssd_chunk_ref(xs, bmat, cmat, dt, a, chunk: int = 256) -> torch.Tensor:
    """Chunked-SSD oracle mirroring models/ssd.ssd_forward's scan math;
    returns y only, in xs's dtype, as the reference oracle does.
    xs: (B,L,H,P); bmat/cmat: (B,L,N); dt: (B,L,H) post-softplus; a: (H,)."""
    from .ssd_scan import ssd_scan_plain
    return ssd_scan_plain(xs, bmat, cmat, dt, a, chunk)[0]
