"""Paged KV cache — fixed-size pages + per-request page tables: the port of
``repro.serve.kvcache``.

The serving analogue of the paper's storage story: a request's KV history is
a *version* of the cache; shared prompt prefixes are shared pages (records),
exactly the CVD's record-dedup applied to attention state.  ``fork`` clones
a request by copying its page table, not its pages (copy-on-write appends) —
the same mechanism as checkout's zero-copy record sharing.

The state is a dict of tensors on one device (the card unless the caller
names the CPU): the pools (L, n_pages, page, n_kv, head_dim) and the
bookkeeping (page tables, lengths, refcounts, the watermark) beside them.
Each operation updates the state's tensors IN PLACE and returns the same
dict (the reference returns new arrays); allocation decisions read the
bookkeeping on the host, one request at a time.  Pages are chosen exactly
as the reference chooses them, so the tables, refcounts, lengths and
watermark equal the reference's after any sequence of operations.

Where the reference's scatter would fall outside its arrays (the pool has
no free page, or a request has used all ``max_pages_per_seq`` of its
pages) and drop the write silently, the port raises ``PlanError`` before
it changes anything.  No TPU kernel serves this module: it is plain torch
on the state's device.  The cache stays meshless, as the reference's
reads no mesh: on a (data, model) mesh the dense cache of
``models.transformer.cache_specs`` serves, not this one.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.build import PlanError
from ..kernels.ops import resolve_device


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    n_layers: int
    n_kv: int
    head_dim: int
    page: int = 64             # tokens per page (sublane multiple)
    n_pages: int = 256         # pool size per layer
    max_pages_per_seq: int = 64


def init_pool(cfg: PagedConfig, batch: int, dtype=torch.bfloat16,
              device=None) -> dict:
    """The cache state on ``device`` (the card unless the caller names the
    CPU).

    k/v:     (L, n_pages, page, n_kv, hd)   the page pools
    table:   (B, max_pages_per_seq) int32   page ids per request (-1 empty)
    length:  (B,) int32                     tokens written per request
    refcnt:  (n_pages,) int32               copy-on-write sharing
    watermark: () int32                     next never-used page
    """
    dev = resolve_device(device)
    pool = (cfg.n_layers, cfg.n_pages, cfg.page, cfg.n_kv, cfg.head_dim)
    return {
        "k": torch.zeros(pool, dtype=dtype, device=dev),
        "v": torch.zeros(pool, dtype=dtype, device=dev),
        "table": torch.full((batch, cfg.max_pages_per_seq), -1,
                            dtype=torch.int32, device=dev),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "refcnt": torch.zeros((cfg.n_pages,), dtype=torch.int32, device=dev),
        "watermark": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _alloc(cfg: PagedConfig, state: dict) -> int:
    """Allocate one page: the first page whose refcount is 0 if it lies
    below the watermark, else the watermark (bumped).  PlanError, with the
    state untouched, when neither exists."""
    refcnt = state["refcnt"]
    free = int(torch.argmin(refcnt))             # first refcnt == 0 page
    wm = int(state["watermark"])
    page = free if int(refcnt[free]) == 0 and free < wm else wm
    if page >= cfg.n_pages:
        raise PlanError(f"paged KV cache: all {cfg.n_pages} pages in use")
    if page == wm:
        state["watermark"].fill_(wm + 1)
    refcnt[page] += 1
    return page


def append(cfg: PagedConfig, state: dict, layer_kv: tuple, req) -> dict:
    """Append ONE token's K/V for request ``req`` across all layers.

    layer_kv: (k, v) each (L, n_kv, hd).  Copy-on-write: if the request's
    current tail page is shared (refcnt > 1), it is copied to a fresh page
    first — forked requests never clobber their sibling's history.
    PlanError when the request has no page left or the pool none free.
    """
    req = int(req)
    length = int(state["length"][req])
    slot, tpos = length % cfg.page, length // cfg.page
    if tpos >= cfg.max_pages_per_seq:
        raise PlanError(f"paged KV cache: request {req} holds {length} "
                        f"tokens, all of its {cfg.max_pages_per_seq} pages")
    table = state["table"]
    if slot == 0:
        table[req, tpos] = _alloc(cfg, state)
    page = int(table[req, tpos])
    if int(state["refcnt"][page]) > 1:            # copy-on-write
        fresh = _alloc(cfg, state)
        state["k"][:, fresh] = state["k"][:, page]
        state["v"][:, fresh] = state["v"][:, page]
        state["refcnt"][page] -= 1
        table[req, tpos] = fresh
        page = fresh
    k_new, v_new = layer_kv
    state["k"][:, page, slot] = k_new.to(state["k"].dtype)
    state["v"][:, page, slot] = v_new.to(state["v"].dtype)
    state["length"][req] += 1
    return state


def _page_counts(state: dict, row: torch.Tensor) -> torch.Tensor:
    """How many times each page appears in a table row (the empty -1
    entries add nothing), as an (n_pages,) int32 tensor."""
    used = row >= 0
    return torch.zeros_like(state["refcnt"]).index_add_(
        0, torch.where(used, row, 0).long(), used.to(torch.int32))


def fork(cfg: PagedConfig, state: dict, src, dst) -> dict:
    """dst becomes a zero-copy clone of src (page-table copy + refcnt bump).
    The paper's checkout: a new version sharing every record."""
    src, dst = int(src), int(dst)
    row = state["table"][src].clone()
    state["refcnt"] += _page_counts(state, row)
    state["table"][dst] = row
    state["length"][dst] = state["length"][src]
    return state


def gather_kv(cfg: PagedConfig, state: dict, req, layer: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize request ``req``'s history for one layer:
    (S_max, n_kv, hd) k/v plus a validity mask (S_max,).  S_max =
    max_pages_per_seq * page — attention masks the tail."""
    row = state["table"][int(req)]
    safe = row.clamp_min(0).long()
    smax = cfg.max_pages_per_seq * cfg.page
    k = state["k"][layer][safe].reshape(smax, cfg.n_kv, cfg.head_dim)
    v = state["v"][layer][safe].reshape(smax, cfg.n_kv, cfg.head_dim)
    mask = torch.arange(smax, device=row.device) < state["length"][int(req)]
    return k, v, mask


def release(cfg: PagedConfig, state: dict, req) -> dict:
    """Drop a finished request: decrement refcounts, clear its table row.
    Pages reaching refcnt 0 become allocatable again."""
    req = int(req)
    state["refcnt"].sub_(_page_counts(state, state["table"][req])
                         ).clamp_(min=0)
    state["table"][req] = -1
    state["length"][req] = 0
    return state


def pool_stats(state: dict) -> dict:
    return {"pages_in_use": int((state["refcnt"] > 0).sum()),
            "watermark": int(state["watermark"]),
            "shared_pages": int((state["refcnt"] > 1).sum())}
