"""Core data types of the emulation engine (port of ``repro/core/types.py``).

The config dataclasses are plain Python and copied field for field from
the reference (same names, defaults, checks and derived properties). The
batch and state types are frozen dataclasses of tensors: virtual time is
float32 microseconds and every index is int32, as in the reference (x64
off), so every tensor this package creates names its dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

# NVMe-ish opcodes.
OP_READ = 0
OP_WRITE = 1

# Sentinel for "no request" slots in fixed-capacity batches.
INVALID = -1

F32 = torch.float32
I32 = torch.int32


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless named.

    With no device named and no card present this raises — the port never
    runs quietly on the CPU; callers that want the CPU (the tests) say so.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the port "
                "on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class RequestBatch:
    """A fixed-capacity batch of I/O requests (struct of (N,) tensors).

    ``valid`` masks live entries; invalid rows carry arbitrary payloads and
    must never influence timing state or the data path.
    """

    arrival: torch.Tensor   # (N,) f32 — virtual submission time (us)
    sq_id: torch.Tensor     # (N,) i32 — submission queue the request came from
    slot: torch.Tensor      # (N,) i32 — slot index within the SQ ring
    opcode: torch.Tensor    # (N,) i32 — OP_READ / OP_WRITE
    lba: torch.Tensor       # (N,) i32 — logical block address
    nblocks: torch.Tensor   # (N,) i32 — blocks per request (>=1)
    buf_id: torch.Tensor    # (N,) i32 — destination/source I/O buffer row
    req_id: torch.Tensor    # (N,) i32 — globally unique request id
    valid: torch.Tensor     # (N,) bool
    tenant: "torch.Tensor | None" = None  # (N,) i32 tenant/QoS class

    @property
    def capacity(self) -> int:
        return self.arrival.shape[0]

    @property
    def tenants(self) -> torch.Tensor:
        """Tenant ids with the ``None`` default lowered to all-zero."""
        if self.tenant is None:
            return torch.zeros_like(self.sq_id)
        return self.tenant

    @staticmethod
    def empty(n: int, device: "torch.device | str") -> "RequestBatch":
        z = torch.zeros((n,), dtype=I32, device=device)
        return RequestBatch(
            arrival=torch.zeros((n,), dtype=F32, device=device),
            sq_id=z, slot=z, opcode=z, lba=z,
            nblocks=torch.ones((n,), dtype=I32, device=device),
            buf_id=z, req_id=z,
            valid=torch.zeros((n,), dtype=torch.bool, device=device),
            tenant=z,
        )


@dataclasses.dataclass(frozen=True)
class StorageOps:
    """A flat batch of storage operations for ``StorageClient.submit``:
    one slot per operation with its opcode, block address, QoS tenant and
    virtual submission clock. ``valid`` masks live slots; invalid slots
    never touch the rings or the device. Build with ``StorageOps.make``."""

    opcode: torch.Tensor    # (N,) i32 — OP_READ / OP_WRITE
    lba: torch.Tensor       # (N,) i32 — logical block address
    t_submit: torch.Tensor  # (N,) f32 — virtual submission clock (us)
    tenant: torch.Tensor    # (N,) i32 — QoS class
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.lba.shape[0]

    @staticmethod
    def make(
        lba: torch.Tensor,
        t_submit: "torch.Tensor | float" = 0.0,
        opcode: "torch.Tensor | int" = OP_READ,
        tenant: "torch.Tensor | int" = 0,
        valid: "torch.Tensor | None" = None,
    ) -> "StorageOps":
        """Broadcasting constructor: scalars fan out to ``lba``'s shape."""
        lba = lba.to(I32)
        shape, dev = lba.shape, lba.device

        def fan(x, dtype):
            if isinstance(x, torch.Tensor):
                return x.to(dev, dtype).expand(shape)
            # A fill on the device: a Python scalar copied to the card
            # would wait for the stream.
            return torch.full(shape, x, dtype=dtype, device=dev)

        if valid is None:
            valid = torch.ones(shape, dtype=torch.bool, device=dev)
        return StorageOps(
            opcode=fan(opcode, I32), lba=lba, t_submit=fan(t_submit, F32),
            tenant=fan(tenant, I32), valid=valid,
        )

    def concat(self, other: "StorageOps") -> "StorageOps":
        """Concatenate two op batches (e.g. faults + write-backs)."""
        return StorageOps(**{
            f.name: torch.cat([getattr(self, f.name), getattr(other, f.name)])
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """Target-device model parameters (NVMeVirt simple timing model).

    ``t_max_iops`` is the sustained random-read ceiling; ``l_min_us`` the
    latency floor. ``n_instances`` abstracts flash channels/controllers: each
    request occupies one instance for ``sched_us = n_instances / t_max_iops``
    seconds of virtual time, so aggregate throughput saturates at t_max.
    The flash-backend fields price writes, GC and mapping misses (flash.py).
    """

    name: str = "solidigm-d7-ps1010"
    t_max_iops: float = 2.47e6
    l_min_us: float = 50.0
    n_instances: int = 64
    block_bytes: int = 512
    num_blocks: int = 1 << 20
    routing: str = "round_robin"
    flash_backend: bool = True
    num_channels: int = 8
    chips_per_channel: int = 4
    flash_read_us: float = 40.0
    flash_program_us: float = 200.0
    flash_erase_us: float = 1000.0
    pages_per_block: int = 64
    over_provision: float = 0.07
    gc_watermark: float = 0.02
    mapping_hit_rate: float = 1.0
    preconditioned: bool = False

    def __post_init__(self) -> None:
        if self.num_channels < 1 or self.chips_per_channel < 1:
            raise ValueError(
                f"num_channels={self.num_channels} and chips_per_channel="
                f"{self.chips_per_channel} must be >= 1"
            )
        if not 0.0 <= self.mapping_hit_rate <= 1.0:
            raise ValueError(
                f"mapping_hit_rate={self.mapping_hit_rate} must be in [0, 1]"
            )
        if self.over_provision <= 0.0:
            raise ValueError(
                f"over_provision={self.over_provision} must be > 0 — with no "
                "spare capacity every write immediately deadlocks on GC"
            )
        if self.gc_watermark >= self.over_provision / (
            1.0 + self.over_provision
        ):
            raise ValueError(
                f"gc_watermark={self.gc_watermark} must be below the "
                f"over-provisioned free fraction "
                f"{self.over_provision / (1.0 + self.over_provision):.4f} — "
                "a fresh drive would start below its own GC trigger"
            )

    @property
    def sched_us(self) -> float:
        return self.n_instances / self.t_max_iops * 1e6

    @property
    def num_chips(self) -> int:
        """Total flash dies = channels x chips/channel."""
        return self.num_channels * self.chips_per_channel

    @property
    def phys_pages(self) -> float:
        """Physical page count including over-provisioned spare area."""
        return self.num_blocks * (1.0 + self.over_provision)

    def replace(self, **kw: Any) -> "SSDConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PlatformModel:
    """Virtual-time cost model of the emulator platform itself (fetch
    path, data path, lock and doorbell costs; see the reference for the
    calibration of each constant)."""

    sqe_bytes: int = 64
    cpu_sqe_fetch_us: float = 10.3
    cpu_coal_byte_us: float = 0.0268
    cpu_coal_base_us: float = 0.30
    dsa_sqe_fetch_us: float = 3.8
    dsa_coal_base_us: float = 18.0
    host_txn_base_us: float = 0.05
    host_bytes_per_us: float = 80000.0
    txn_base_us: float = 0.30
    link_bytes_per_us: float = 32000.0
    per_req_map_us: float = 2.90
    dsa_desc_issue_us: float = 0.020
    dsa_batch_setup_us: float = 0.25
    dsa_bytes_per_us: float = 30000.0
    lock_per_req_us: float = 0.085
    lock_per_batch_us: float = 0.40
    doorbell_poll_us: float = 0.02

    def replace(self, **kw: Any) -> "PlatformModel":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class QPConfig:
    """Queue-pair completion-side knobs (the CQ mirror of the SQ rings).
    The defaults are neutral: the completion path adds no virtual time."""

    cq_coalesce_n: int = 1
    cq_coalesce_us: float = 0.0
    cq_doorbell_us: float = 0.0
    cq_poll_us: float = 0.0
    cqe_reap_us: float = 0.0

    def __post_init__(self) -> None:
        if self.cq_coalesce_n < 1:
            raise ValueError(
                f"cq_coalesce_n={self.cq_coalesce_n} must be >= 1"
            )
        for name in (
            "cq_coalesce_us", "cq_doorbell_us", "cq_poll_us", "cqe_reap_us"
        ):
            if getattr(self, name) < 0.0:
                raise ValueError(f"{name} must be >= 0")

    @property
    def neutral(self) -> bool:
        """True iff the completion path cannot change any virtual time."""
        return (
            self.cq_coalesce_n == 1
            and self.cq_coalesce_us == 0.0
            and self.cq_doorbell_us == 0.0
            and self.cq_poll_us == 0.0
            and self.cqe_reap_us == 0.0
        )

    def replace(self, **kw: Any) -> "QPConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """NIC/link hop between the GPU initiator and a *remote* drive.
    ``remote=False`` (the default) skips the hop entirely."""

    remote: bool = False
    rtt_us: float = 0.0
    tx_bytes_per_us: float = float("inf")
    rx_bytes_per_us: float = float("inf")
    wire_txn_us: float = 0.0
    mtu_batch: int = 1
    mtu_timeout_us: float = 0.0
    cqe_bytes: int = 16
    switch_bytes_per_us: float = float("inf")
    switch_fanin: int = 1
    qos_weights: tuple = ()

    def __post_init__(self) -> None:
        if self.mtu_batch < 1:
            raise ValueError(f"mtu_batch={self.mtu_batch} must be >= 1")
        if self.tx_bytes_per_us <= 0.0 or self.rx_bytes_per_us <= 0.0:
            raise ValueError(
                "tx_bytes_per_us and rx_bytes_per_us must be > 0 "
                "(use inf for an unconstrained link)"
            )
        if self.switch_bytes_per_us <= 0.0:
            raise ValueError(
                "switch_bytes_per_us must be > 0 "
                "(use inf for an unconstrained switch)"
            )
        if self.switch_fanin < 1:
            raise ValueError(
                f"switch_fanin={self.switch_fanin} must be >= 1"
            )
        if any(w <= 0.0 for w in self.qos_weights):
            raise ValueError(
                f"qos_weights={self.qos_weights} must all be > 0 — a "
                "zero-weight tenant would never be scheduled"
            )
        if self.cqe_bytes < 1:
            raise ValueError(f"cqe_bytes={self.cqe_bytes} must be >= 1")
        for name in ("rtt_us", "wire_txn_us", "mtu_timeout_us"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"{name} must be >= 0")

    @property
    def num_tenants(self) -> int:
        """Tenant classes the WFQ arbiter distinguishes (1 = off)."""
        return max(1, len(self.qos_weights))

    @property
    def switched(self) -> bool:
        """True iff the shared-switch stage prices anything at all."""
        return self.remote and math.isfinite(self.switch_bytes_per_us)

    @property
    def switch_share_bytes_per_us(self) -> float:
        """One link's fair share of the aggregate switch roof."""
        return self.switch_bytes_per_us / self.switch_fanin

    @property
    def neutral(self) -> bool:
        """True iff the hop cannot change any virtual time."""
        return (not self.remote) or (
            self.rtt_us == 0.0
            and self.wire_txn_us == 0.0
            and math.isinf(self.tx_bytes_per_us)
            and math.isinf(self.rx_bytes_per_us)
            and math.isinf(self.switch_bytes_per_us)
            and (self.mtu_batch == 1 or self.mtu_timeout_us == 0.0)
        )

    def replace(self, **kw: Any) -> "FabricConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """GPU-side set-associative page cache (pipeline stage 0)."""

    enabled: bool = False
    num_sets: int = 512
    ways: int = 4
    hit_us: float = 0.5
    chase: int = 2
    readahead: int = 0

    def __post_init__(self) -> None:
        if self.num_sets < 1 or self.ways < 1:
            raise ValueError(
                f"num_sets={self.num_sets} and ways={self.ways} must be >= 1"
            )
        if self.chase < 1:
            raise ValueError(f"chase={self.chase} must be >= 1")
        if self.hit_us < 0.0 or self.readahead < 0:
            raise ValueError("hit_us and readahead must be >= 0")

    @property
    def capacity(self) -> int:
        return self.num_sets * self.ways

    def replace(self, **kw: Any) -> "CacheConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Closed-loop synthetic workload (fio / BaM analogue)."""

    io_depth: int = 64
    read_frac: float = 1.0
    resubmit_delay_us: float = 1.0
    seed: int = 0

    def replace(self, **kw: Any) -> "WorkloadConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Emulation-engine shape parameters (static per run).

    ``use_pallas`` (block_gather), ``use_pallas_segscan`` (seg_scan),
    ``use_pallas_reap`` (fused_reap) and ``use_pallas_flash``
    (die_contention) keep the reference's names and defaults; in the port
    each routes its stage through the hand-written CUDA kernel for a CUDA
    tensor and through the kernel's plain PyTorch version for a CPU tensor
    (``kernels/ops.py``).
    """

    num_sqs: int = 32
    sq_depth: int = 1024
    fetch_width: int = 64
    num_units: int = 1
    workers_per_unit: int = 1
    num_bufs: int = 1 << 15
    mode: str = "aggregated"
    frontend: str = "distributed"
    coalesced: bool = True
    dsa_fetch: bool = True
    batched_datapath: bool = True
    timing_scope: str = "global"
    transport: str = "p2p"
    poll_quantum_us: float = 10.0
    emulate_data: bool = True
    use_pallas: bool = False
    use_sort_plan: bool = True
    use_compaction: bool = True
    use_pallas_segscan: "bool | None" = None
    lock_order: str = "program"
    use_pallas_reap: bool = False
    use_pallas_flash: bool = False
    sanitize: bool = False
    qp: QPConfig = QPConfig()
    cache: CacheConfig = CacheConfig()
    fabric: FabricConfig = FabricConfig()

    def __post_init__(self) -> None:
        if self.num_sqs < 1 or self.sq_depth < 1:
            raise ValueError(
                f"num_sqs={self.num_sqs} and sq_depth={self.sq_depth} "
                "must be >= 1"
            )
        if self.num_units < 1 or self.workers_per_unit < 1:
            raise ValueError(
                f"num_units={self.num_units} and workers_per_unit="
                f"{self.workers_per_unit} must be >= 1"
            )
        if self.fetch_width < 1 or self.fetch_width > self.sq_depth:
            raise ValueError(
                f"fetch_width={self.fetch_width} must be in "
                f"[1, sq_depth={self.sq_depth}] — a dispatcher cannot fetch "
                "more entries than a ring holds"
            )
        if self.frontend not in ("distributed", "centralized"):
            raise ValueError(f"unknown frontend: {self.frontend!r}")
        if self.mode not in ("aggregated", "per_request"):
            raise ValueError(f"unknown timing mode: {self.mode!r}")
        if self.timing_scope not in ("global", "local"):
            raise ValueError(f"unknown timing_scope: {self.timing_scope!r}")
        if self.lock_order not in ("program", "ready_time"):
            raise ValueError(f"unknown lock_order: {self.lock_order!r}")
        if self.transport not in ("p2p", "host"):
            raise ValueError(f"unknown transport: {self.transport!r}")
        units = self.num_units if self.frontend == "distributed" else 1
        if self.num_sqs % units != 0:
            raise ValueError(
                f"num_sqs={self.num_sqs} must be divisible by num_units="
                f"{units} — SQs are statically partitioned across service "
                "units (a remainder would silently mis-shape the fetch batch)"
            )

    def replace(self, **kw: Any) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    def resolve_pallas_segscan(
        self, ssd: "SSDConfig", plat: "PlatformModel"
    ) -> bool:
        """Resolve the ``use_pallas_segscan`` auto default (``None``):
        explicit ``True``/``False`` wins, ``None`` resolves to the
        ``integer_timestamps`` proof that the kernel route is bit-exact."""
        if self.use_pallas_segscan is not None:
            return self.use_pallas_segscan
        return integer_timestamps(self, ssd, plat)


def integer_timestamps(
    cfg: "EngineConfig", ssd: "SSDConfig", plat: "PlatformModel"
) -> bool:
    """True iff every config-derived virtual-time cost is integer-valued.

    The static bit-exactness precondition for the segmented-scan kernel
    route (``queueing_scan_via_segmax``): integer-valued f32 sums below
    2^24 are exact under any association. Conservative — a False is
    always safe.
    """

    def ints(*vals: float) -> bool:
        return all(float(v).is_integer() for v in vals)

    def div_ok(nbytes: float, bw: float) -> bool:
        return math.isinf(bw) or (float(nbytes) / bw).is_integer()

    if cfg.batched_datapath:
        return False  # dsa_worker_times carries fractional constants
    if not ints(
        plat.cpu_sqe_fetch_us, plat.cpu_coal_byte_us, plat.cpu_coal_base_us,
        plat.dsa_sqe_fetch_us, plat.dsa_coal_base_us, plat.host_txn_base_us,
        plat.txn_base_us, plat.per_req_map_us, plat.dsa_desc_issue_us,
        plat.dsa_batch_setup_us, plat.lock_per_req_us, plat.lock_per_batch_us,
        plat.doorbell_poll_us, cfg.poll_quantum_us,
    ):
        return False
    if not (
        div_ok(ssd.block_bytes, plat.link_bytes_per_us)
        and div_ok(ssd.block_bytes, plat.host_bytes_per_us)
        and div_ok(ssd.block_bytes, plat.dsa_bytes_per_us)
        and div_ok(plat.sqe_bytes, plat.host_bytes_per_us)
    ):
        return False
    if not ints(ssd.sched_us, ssd.l_min_us):
        return False
    if ssd.flash_backend and not ints(
        ssd.flash_read_us, ssd.flash_program_us, ssd.flash_erase_us
    ):
        return False
    if cfg.cache.enabled and not ints(cfg.cache.hit_us):
        return False
    if not ints(
        cfg.qp.cq_coalesce_us, cfg.qp.cq_doorbell_us,
        cfg.qp.cq_poll_us, cfg.qp.cqe_reap_us,
    ):
        return False
    fab = cfg.fabric
    if fab.remote:
        if fab.num_tenants > 1:
            return False  # GPS weight ratios inflate costs fractionally
        if not ints(0.5 * fab.rtt_us, fab.wire_txn_us, fab.mtu_timeout_us):
            return False
        if not (
            div_ok(plat.sqe_bytes, fab.tx_bytes_per_us)
            and div_ok(ssd.block_bytes, fab.tx_bytes_per_us)
            and div_ok(fab.cqe_bytes, fab.rx_bytes_per_us)
            and div_ok(ssd.block_bytes, fab.rx_bytes_per_us)
        ):
            return False
        if fab.switched and not (
            div_ok(plat.sqe_bytes, fab.switch_share_bytes_per_us)
            and div_ok(ssd.block_bytes, fab.switch_share_bytes_per_us)
            and div_ok(fab.cqe_bytes, fab.switch_share_bytes_per_us)
        ):
            return False
    return True


@dataclasses.dataclass(frozen=True)
class TimingState:
    """Shared timing-model state: per-scheduling-instance busy-until times
    plus the round-robin assignment cursor (dispatch-order routing)."""

    busy_until: torch.Tensor  # (K,) f32 virtual us
    rr: torch.Tensor          # ()  i32 next instance for round-robin routing

    @staticmethod
    def init(n_instances: int, device: "torch.device | str") -> "TimingState":
        return TimingState(
            busy_until=torch.zeros((n_instances,), dtype=F32, device=device),
            rr=torch.zeros((), dtype=I32, device=device),
        )
