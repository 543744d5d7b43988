"""SSD-backed cold KV-cache tier (port of ``repro/serving/kv_tier.py``).

The decode path keeps a ``hot_window`` of recent KV pages in HBM; all
older pages live on the emulated SSD and every decode step faults them
in (full attention reads the whole history). The virtual-time engine
prices those reads, so tokens/s becomes a function of device IOPS.

The tier runs the real paged KV cache over the real device pipeline:
logical pages map to LBAs through the live page table (physical page p
owns the block run ``[p*nb, (p+1)*nb)`` in its layer's region), and one
decode step submits ONE mixed ``StorageOps`` batch — the cold-page fault
reads and the demoted page's write-back under the decode tenant, plus an
optional background read stream under the prefill tenant — through
``StorageClient.submit``. The bytes each fault gathers are checked
against the live pool every step (``data_check_max_abs``, must be 0.0).

Step latency is ``max(gpu_step_us, storage critical path)``, the critical
path being the latest completion among the decode tenant's ops. The
reference scans over tokens and steps; here Python loops take their
place, and nothing inside a step reads a value back to the host. A tier
over several drives (``num_devices > 1``) stripes each step's batch
round-robin over an emulated array (``StorageClient.submit_striped``,
the drives' state stacked on a leading axis). With ``EngineConfig.cache``
enabled the client's stage-0 page cache serves re-faulted cold pages at
GPU-local latency (fig 28's hot-window x cache sweep).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.client import ClientState, StorageClient
from repro_torch.core.types import (
    F32,
    I32,
    OP_WRITE,
    EngineConfig,
    PlatformModel,
    SSDConfig,
    StorageOps,
    resolve_device,
)
from repro_torch.models.config import ModelConfig
from repro_torch.serving import paged_kv as pk


@dataclasses.dataclass(frozen=True)
class KVTierConfig:
    page_tokens: int = 16          # tokens per KV page
    hot_window: int = 1024         # tokens kept in HBM
    block_bytes: int = 512         # SSD I/O granularity
    gpu_step_us: float = 150.0     # modeled per-token GPU compute time
    decode_tenant: int = 0         # QoS class: faults + write-backs
    prefill_tenant: int = 1        # QoS class: prefill flush + bulk
    bulk_blocks_per_step: int = 0  # bulk-tenant ingest reads/step
    num_devices: int = 1           # > 1: stripe over a drive array
    stripe_width: "int | None" = None

    @property
    def hot_pages(self) -> int:
        """Pages of the hot window (>= 1: the page being written)."""
        return max(self.hot_window // self.page_tokens, 1)


def kv_page_blocks(cfg: ModelConfig, tier: KVTierConfig) -> int:
    """512-byte blocks needed to read one (layer, kv-head) page (K+V)."""
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    page_bytes = 2 * tier.page_tokens * cfg.d_head * dtype_bytes
    return -(-page_bytes // tier.block_bytes)


def cold_blocks_per_step(
    cfg: ModelConfig, tier: KVTierConfig, cache_len: int
) -> int:
    """Analytic block reads one decode step faults in (full attention);
    the live tier reports the actual count (``blocks_per_step``)."""
    cold_tokens = max(cache_len - tier.hot_window, 0)
    pages = -(-cold_tokens // tier.page_tokens)
    return pages * kv_page_blocks(cfg, tier) * cfg.n_kv_heads * cfg.n_layers


def paged_cfg_for(
    cfg: ModelConfig,
    tier: KVTierConfig,
    batch: int,
    start_len: int,
    n_steps: int,
) -> pk.PagedKVConfig:
    """PagedKVConfig sized exactly for a (batch, start_len + n_steps)
    serving run of one layer group of ``cfg``."""
    mp = -(-(start_len + n_steps) // tier.page_tokens)
    return pk.PagedKVConfig(
        page_tokens=tier.page_tokens,
        n_pages=batch * mp,
        max_pages=mp,
        kv_heads=cfg.n_kv_heads,
        head_dim=cfg.d_head,
        dtype=cfg.dtype,
    )


@dataclasses.dataclass(frozen=True)
class TierState:
    """Live serving-tier state carried across decode steps."""

    client: ClientState      # device or array virtual-time state
    kv: pk.PagedKV           # the real paged KV cache (page tables)
    flash: torch.Tensor      # (flash_blocks, block_values) block store
    clock: torch.Tensor      # () f32 virtual time (us)


def region_block_values(pcfg: pk.PagedKVConfig, tier: KVTierConfig) -> int:
    """Values per block row: one flash row is one block's payload."""
    itemsize = torch.empty((), dtype=getattr(torch, pcfg.dtype)).element_size()
    return tier.block_bytes // itemsize


def _submit(storage, tier, client, flash, ops, data):
    """One mixed op batch down the client path, striped over the array
    when the tier spans several drives."""
    if tier.num_devices > 1:
        return storage.submit_striped(
            client, flash, ops, data=data,
            stripe_width=tier.stripe_width, with_data=True,
        )
    return storage.submit(client, flash, ops, data=data, with_data=True)


def _page_write_ops(kv, pcfg, tier, mask, layers, region, clock, tenant):
    """Write-back ops + payload rows for every masked (B, MP) page,
    tiled over the per-layer LBA regions."""
    nb = pk.page_blocks(pcfg, tier.block_bytes)
    bv = region_block_values(pcfg, tier)
    lay = torch.arange(layers, dtype=I32, device=clock.device)
    runs = pk.page_run_lbas(kv.page_table, nb)           # (B, MP, nb)
    lba = runs[:, :, None, :] + (lay * region)[None, None, :, None]
    valid = mask[:, :, None, None].expand(lba.shape)
    ops = StorageOps.make(
        lba.reshape(-1), clock, opcode=OP_WRITE, tenant=tenant,
        valid=valid.reshape(-1),
    )
    packed = pk.pack_pages(kv, pcfg, bv)                 # (P, nb, bv)
    rows = packed[torch.clamp(kv.page_table, min=0).long()]  # (B, MP, nb, bv)
    data = rows[:, :, None].expand(lba.shape + (bv,)).reshape(-1, bv)
    return ops, data


def init_tier(
    storage: StorageClient,
    pcfg: pk.PagedKVConfig,
    tier: KVTierConfig,
    batch: int,
    flash_blocks: int,
    device: "torch.device | str | None" = None,
) -> TierState:
    """Fresh tier on ``device`` (``cuda`` unless named): empty paged KV,
    zeroed block store, clock zero."""
    device = resolve_device(device)
    bv = region_block_values(pcfg, tier)
    client = (storage.init_array_state(tier.num_devices, device)
              if tier.num_devices > 1 else storage.init_state(device))
    return TierState(
        client=client,
        kv=pk.init_paged(pcfg, batch, device),
        flash=torch.zeros((flash_blocks, bv), dtype=F32, device=device),
        clock=torch.zeros((), dtype=F32, device=device),
    )


def prefill_flush(
    state: TierState,
    storage: StorageClient,
    pcfg: pk.PagedKVConfig,
    tier: KVTierConfig,
    layers: int,
    region: int,
) -> TierState:
    """Flush every cold page of a prefilled cache to its LBA run in one
    prefill-tenant write batch; the clock advances to the flush's
    completion, so decode starts with every faultable page on flash."""
    cold = pk.cold_page_mask(state.kv, pcfg, tier.hot_pages)
    ops, data = _page_write_ops(
        state.kv, pcfg, tier, cold, layers, region, state.clock,
        tier.prefill_tenant,
    )
    client, flash, _, done = _submit(storage, tier, state.client,
                                     state.flash, ops, data)
    clock = torch.amax(torch.where(ops.valid, done, state.clock))
    return TierState(client=client, kv=state.kv, flash=flash, clock=clock)


def tier_step(
    state: TierState,
    storage: StorageClient,
    pcfg: pk.PagedKVConfig,
    tier: KVTierConfig,
    layers: int,
    region: int,
    k_new: torch.Tensor,     # (B, H, D) this step's keys
    v_new: torch.Tensor,
    step_idx: int,           # cycles the bulk scratch region
) -> "tuple[TierState, dict]":
    """One decode step against the live tier: append the token, then
    submit ONE mixed batch of fault reads for every cold page, the
    demoted page's write-back and the optional bulk stream. Returns
    (state', per-step stats as 0-dim device tensors) with the clock
    advanced by ``max(gpu_step_us, storage critical path)``."""
    nb = pk.page_blocks(pcfg, tier.block_bytes)
    bv = region_block_values(pcfg, tier)
    b, mp = state.kv.page_table.shape
    dev = state.clock.device
    lay = torch.arange(layers, dtype=I32, device=dev)

    kv_new = pk.append_token(state.kv, pcfg, k_new, v_new)

    # Fault reads: pages cold *before* this token (the demoted page is
    # still resident this step — it is being evicted, not re-read).
    cold = pk.cold_page_mask(state.kv, pcfg, tier.hot_pages)
    runs = pk.page_run_lbas(state.kv.page_table, nb)      # (B, MP, nb)
    r_lba = runs[:, :, None, :] + (lay * region)[None, None, :, None]
    r_valid = cold[:, :, None, None].expand(r_lba.shape)
    n_read = b * mp * layers * nb
    read_ops = StorageOps.make(
        r_lba.reshape(-1), state.clock, tenant=tier.decode_tenant,
        valid=r_valid.reshape(-1),
    )

    # Write-back: the page (at most one per sequence) that just left the
    # hot window is demoted from HBM to its LBA run.
    demoted = pk.cold_page_mask(kv_new, pcfg, tier.hot_pages) & ~cold
    write_ops, w_data = _page_write_ops(
        kv_new, pcfg, tier, demoted, layers, region, state.clock,
        tier.decode_tenant,
    )

    ops = read_ops.concat(write_ops)
    data = torch.cat([torch.zeros((n_read, bv), dtype=F32, device=dev),
                      w_data])

    # Background bulk stream (prefill tenant): context-ingest reads
    # cycling through the scratch region past the KV regions. Priced —
    # it congests the device — but it never gates the decode step.
    nbulk = tier.bulk_blocks_per_step
    if nbulk:
        scratch0 = layers * region
        scratch = state.flash.shape[0] - scratch0
        b_lba = scratch0 + torch.remainder(
            step_idx * nbulk + torch.arange(nbulk, dtype=I32, device=dev),
            scratch,
        )
        ops = ops.concat(StorageOps.make(b_lba, state.clock,
                                         tenant=tier.prefill_tenant))
        data = torch.cat([data, torch.zeros((nbulk, bv), dtype=F32,
                                            device=dev)])

    client, flash, out, done = _submit(storage, tier, state.client,
                                       state.flash, ops, data)

    # Step latency: GPU compute overlaps the decode tenant's storage
    # critical path (latest fault or write-back completion).
    gating = ops.valid & (ops.tenant == tier.decode_tenant)
    t_done = torch.amax(torch.where(gating, done, state.clock))
    storage_us = t_done - state.clock
    step_us = torch.clamp(storage_us, min=tier.gpu_step_us)

    # Data integrity: gathered fault bytes == live pool contents (cold
    # pages' pool rows never change after demotion).
    packed = pk.pack_pages(kv_new, pcfg, bv)
    exp = packed[torch.clamp(state.kv.page_table, min=0).long()]
    exp = exp[:, :, None].expand(r_lba.shape + (bv,))
    err = torch.abs(out[:n_read].reshape(exp.shape) - exp)
    err = torch.amax(torch.where(r_valid[..., None], err, 0.0))

    stats = {
        "storage_us": storage_us,
        "step_us": step_us,
        "blocks": torch.sum(gating, dtype=I32),
        "data_err": err,
    }
    state = TierState(client=client, kv=kv_new, flash=flash,
                      clock=state.clock + step_us)
    return state, stats


def _synth_kv(pcfg: pk.PagedKVConfig, batch: int, t: int, device):
    """Deterministic per-token KV payload (distinct across t/b/h/d) so the
    round-trip check exercises the bytes."""
    h, d = pcfg.kv_heads, pcfg.head_dim
    tt = torch.remainder(torch.full((), t, dtype=F32, device=device),
                         509.0) * 0.0625
    grid = (
        torch.arange(batch, dtype=F32, device=device)[:, None, None] * 0.5
        + torch.arange(h, dtype=F32, device=device)[None, :, None] * 0.125
        + torch.arange(d, dtype=F32, device=device)[None, None, :] * 0.03125
    )
    dt = getattr(torch, pcfg.dtype)
    return (tt + grid).to(dt), (tt - grid).to(dt)


def decode_tokens_per_s(
    cfg: ModelConfig,
    tier: KVTierConfig,
    ssd: SSDConfig,
    ecfg: EngineConfig,
    batch: int,
    start_len: int,
    n_steps: int,
    plat: "PlatformModel | None" = None,
    flash_blocks: int = 1 << 14,
    device: "torch.device | str | None" = None,
) -> dict:
    """Virtual-time decode throughput with the SSD-backed cold KV tier, on
    ``device`` (``cuda`` unless named).

    Prefills ``start_len`` tokens into a paged KV cache, flushes the cold
    pages to flash, then runs ``n_steps`` decode steps, each faulting its
    cold pages through the page tables and writing back demotions in one
    mixed ``StorageClient.submit`` batch. Returns aggregate stats,
    including the IOPS demand and ``data_check_max_abs`` (must be 0.0);
    the host reads the per-step stats once, after the last step."""
    device = resolve_device(device)
    storage = StorageClient(ssd, ecfg, plat or PlatformModel())
    pcfg = paged_cfg_for(cfg, tier, batch, start_len, n_steps)
    layers = max(cfg.n_layers, 1)
    nb = pk.page_blocks(pcfg, tier.block_bytes)
    region = pcfg.n_pages * nb
    needed = layers * region + max(tier.bulk_blocks_per_step, 1)
    flash_blocks = max(flash_blocks, needed)

    state = init_tier(storage, pcfg, tier, batch, flash_blocks, device)
    kv = state.kv
    for t in range(start_len):
        kv = pk.append_token(kv, pcfg, *_synth_kv(pcfg, batch, t, device))
    state = dataclasses.replace(state, kv=kv)
    state = prefill_flush(state, storage, pcfg, tier, layers, region)

    steps = []
    for i in range(n_steps):
        k, v = _synth_kv(pcfg, batch, start_len + i, device)
        state, stats = tier_step(state, storage, pcfg, tier, layers, region,
                                 k, v, i)
        steps.append(stats)
    stats = {key: torch.stack([s[key] for s in steps]) for key in steps[0]}

    step_us = stats["step_us"]
    total_us = float(torch.sum(step_us))
    blocks = float(torch.mean(stats["blocks"].to(F32)))
    return {
        "tokens_per_s": batch * n_steps / (total_us * 1e-6),
        "avg_step_us": total_us / n_steps,
        "avg_storage_us": float(torch.mean(stats["storage_us"])),
        "blocks_per_step": blocks,
        "iops_demand": blocks / (float(torch.mean(step_us)) * 1e-6),
        "data_check_max_abs": float(torch.amax(stats["data_err"])),
        "hot_pages": tier.hot_pages,
    }
