"""Paged KV cache: vLLM-style page tables over a physical page pool (port
of ``repro/serving/paged_kv.py``).

Pages are the unit both of HBM allocation and of SSD-tier I/O: a page
across kv-heads flattens to a run of 512-byte blocks, so faulting a cold
page from the emulated device is the block-granular read stream the
engine prices.

Layout:
    pool:        (n_pages, page_tokens, kv_heads, head_dim)  x2 (k, v)
    page_table:  (batch, max_pages) i32 — logical page -> physical page
    lengths:     (batch,) i32

Every function returns new tensors and leaves its inputs as they were,
as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.types import I32, StorageOps, resolve_device


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    page_tokens: int = 16
    n_pages: int = 256          # physical pool size
    max_pages: int = 32         # logical pages per sequence
    kv_heads: int = 4
    head_dim: int = 32
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class PagedKV:
    k_pool: torch.Tensor       # (P, T, H, D)
    v_pool: torch.Tensor
    page_table: torch.Tensor   # (B, max_pages) i32, -1 = unmapped
    lengths: torch.Tensor      # (B,) i32
    free_head: torch.Tensor    # () i32 — bump allocator over the pool


def _dtype(cfg: PagedKVConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_paged(cfg: PagedKVConfig, batch: int,
               device: "torch.device | str | None" = None) -> PagedKV:
    """Empty paged cache on ``device`` (``cuda`` unless named)."""
    device = resolve_device(device)
    shape = (cfg.n_pages, cfg.page_tokens, cfg.kv_heads, cfg.head_dim)
    return PagedKV(
        k_pool=torch.zeros(shape, dtype=_dtype(cfg), device=device),
        v_pool=torch.zeros(shape, dtype=_dtype(cfg), device=device),
        page_table=torch.full((batch, cfg.max_pages), -1, dtype=I32,
                              device=device),
        lengths=torch.zeros((batch,), dtype=I32, device=device),
        free_head=torch.zeros((), dtype=I32, device=device),
    )


def append_token(
    kv: PagedKV, cfg: PagedKVConfig,
    k_new: torch.Tensor,   # (B, H, D)
    v_new: torch.Tensor,
) -> PagedKV:
    """Append one token per sequence, allocating pages on boundaries."""
    b = k_new.shape[0]
    rows = torch.arange(b, device=k_new.device)
    pos = kv.lengths
    lpage = torch.div(pos, cfg.page_tokens, rounding_mode="floor").long()
    offset = torch.remainder(pos, cfg.page_tokens).long()
    needs_page = offset == 0
    # Bump-allocate physical pages for sequences crossing a boundary.
    alloc_rank = torch.cumsum(needs_page.to(I32), 0, dtype=I32) - 1
    new_phys = kv.free_head + alloc_rank
    table = kv.page_table.clone()
    table[rows, lpage] = torch.where(needs_page, new_phys,
                                     kv.page_table[rows, lpage])
    phys = table[rows, lpage].long()
    k_pool = kv.k_pool.clone()
    v_pool = kv.v_pool.clone()
    k_pool[phys, offset] = k_new
    v_pool[phys, offset] = v_new
    return PagedKV(
        k_pool=k_pool, v_pool=v_pool, page_table=table,
        lengths=kv.lengths + 1,
        free_head=kv.free_head + torch.sum(needs_page.to(I32), dtype=I32),
    )


def gather_dense(
    kv: PagedKV, cfg: PagedKVConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (B, H, S_max, D) caches from the page tables."""
    b = kv.page_table.shape[0]
    phys = torch.clamp(kv.page_table, min=0).long()     # (B, MP)
    mp, t = cfg.max_pages, cfg.page_tokens
    mask = (kv.page_table >= 0)[:, :, None, None, None]

    def dense(pool):
        x = torch.where(mask, pool[phys], 0)             # (B, MP, T, H, D)
        return x.reshape(b, mp * t, cfg.kv_heads, cfg.head_dim).transpose(1, 2)

    return dense(kv.k_pool), dense(kv.v_pool)


def page_blocks(cfg: PagedKVConfig, block_bytes: int = 512) -> int:
    """512-byte device blocks per page (both K and V fragments)."""
    itemsize = torch.empty((), dtype=_dtype(cfg)).element_size()
    page_bytes = 2 * cfg.page_tokens * cfg.kv_heads * cfg.head_dim * itemsize
    return -(-page_bytes // block_bytes)


def cold_page_mask(
    kv: PagedKV, cfg: PagedKVConfig, hot_pages: int
) -> torch.Tensor:
    """(B, max_pages) bool — mapped pages older than the hot window: page
    p is cold when it trails the page being written by more than
    ``hot_pages``."""
    cur_page = torch.div(kv.lengths, cfg.page_tokens, rounding_mode="floor")
    page_idx = torch.arange(cfg.max_pages, device=kv.lengths.device)[None, :]
    return (kv.page_table >= 0) & (page_idx < cur_page[:, None] - hot_pages)


def page_run_lbas(page_table: torch.Tensor, nb: int) -> torch.Tensor:
    """(B, MP) page table -> (B, MP, nb) i32 LBA runs: physical page p
    owns blocks ``[p * nb, (p + 1) * nb)`` (unmapped entries clamp to page
    0; callers mask them)."""
    return (
        torch.clamp(page_table, min=0)[..., None] * nb
        + torch.arange(nb, dtype=I32, device=page_table.device)[None, None, :]
    )


def pack_pages(
    kv: PagedKV, cfg: PagedKVConfig, block_values: int
) -> torch.Tensor:
    """The pool's on-device block image, (n_pages, nb, block_values) f32:
    page p's K then V values, flattened and zero-padded to ``nb`` blocks
    of ``block_values`` values."""
    p = kv.k_pool.shape[0]
    flat = torch.cat(
        [kv.k_pool.reshape(p, -1), kv.v_pool.reshape(p, -1)], dim=1
    ).float()
    nb = -(-flat.shape[1] // block_values)
    flat = torch.nn.functional.pad(flat, (0, nb * block_values - flat.shape[1]))
    return flat.reshape(p, nb, block_values)


def fault_pages_virtual_time(
    kv: PagedKV, cfg: PagedKVConfig, storage, cstate, flash,
    t_submit, hot_pages: int = 2, tenant: int = 0,
):
    """Price one decode step's cold-page faults through the client: every
    mapped page older than ``hot_pages`` is a device read of
    ``page_blocks`` blocks at its page-table LBA run. Returns
    (client_state', completion_time)."""
    nb = page_blocks(cfg)
    cold = cold_page_mask(kv, cfg, hot_pages)
    lba = torch.remainder(page_run_lbas(kv.page_table, nb).reshape(-1),
                          flash.shape[0])
    valid = torch.repeat_interleave(cold.reshape(-1), nb)
    ops = StorageOps.make(lba.to(I32), t_submit, tenant=tenant, valid=valid)
    cstate, _, _, done = storage.submit(cstate, flash, ops)
    return cstate, torch.amax(done)
