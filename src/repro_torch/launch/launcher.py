"""Cluster supervision policy (port of ``repro/launch/launcher.py``, which
imports no JAX; the port keeps its own copy): heartbeats, restart, elastic resize,
straggler mitigation. Pure-policy implementation (no real RPC) so the exact
decision logic that would drive a 1000-node deployment is unit-testable.

Deployment model (matching the dry-run meshes): N workers (pods/hosts) emit
heartbeats; the supervisor detects dead workers (heartbeat age > timeout),
requests restart-from-checkpoint, and if spares are exhausted chooses an
elastic downsize to the largest runnable mesh (reshard-on-load handles the
checkpoint). Straggler policy: per-step completion times are tracked; a
worker slower than ``straggler_factor``× the median for ``patience``
consecutive steps gets its data shard re-dispatched to a backup (the
deterministic counter-hashed pipeline makes re-dispatch free).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List


@dataclasses.dataclass
class SupervisorConfig:
    heartbeat_timeout_s: float = 60.0
    straggler_factor: float = 1.5
    straggler_patience: int = 3
    allowed_data_sizes: tuple = (16, 8, 4, 2, 1)  # elastic mesh choices


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float
    step_times: List[float] = dataclasses.field(default_factory=list)
    slow_streak: int = 0
    alive: bool = True


class Supervisor:
    def __init__(self, n_workers: int, cfg: SupervisorConfig | None = None):
        self.cfg = cfg or SupervisorConfig()
        now = time.time()
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState(last_heartbeat=now) for i in range(n_workers)
        }
        self.restarts = 0

    # --- heartbeat / liveness -------------------------------------------
    def heartbeat(self, worker: int, t: float | None = None):
        self.workers[worker].last_heartbeat = t or time.time()
        self.workers[worker].alive = True

    def dead_workers(self, now: float | None = None) -> List[int]:
        now = now or time.time()
        return [
            w for w, st in self.workers.items()
            if st.alive and now - st.last_heartbeat > self.cfg.heartbeat_timeout_s
        ]

    def handle_failures(self, now: float | None = None) -> dict:
        """Returns the action: restart in place, or elastic downsize."""
        dead = self.dead_workers(now)
        if not dead:
            return {"action": "none"}
        for w in dead:
            self.workers[w].alive = False
        alive = sum(1 for st in self.workers.values() if st.alive)
        self.restarts += 1
        # Prefer restart at full size (spare capacity assumed = failed nodes
        # come back); if the alive count can't fill the mesh, downsize to
        # the largest allowed data-parallel extent.
        target = next(
            (s for s in self.cfg.allowed_data_sizes if s <= alive),
            None,
        )
        if target is None:
            return {"action": "abort", "dead": dead}
        if target == len(self.workers):
            return {"action": "restart", "dead": dead,
                    "from": "latest_checkpoint"}
        return {
            "action": "elastic_downsize", "dead": dead,
            "new_data_parallel": target, "from": "latest_checkpoint",
            "reshard": True,
        }

    # --- stragglers -------------------------------------------------------
    def report_step_time(self, worker: int, seconds: float):
        st = self.workers[worker]
        st.step_times.append(seconds)
        if len(st.step_times) > 32:
            st.step_times.pop(0)

    def straggler_actions(self) -> List[dict]:
        alive = [w for w, st in self.workers.items() if st.alive]
        lasts = sorted(
            st.step_times[-1] for w, st in self.workers.items()
            if st.alive and st.step_times
        )
        if len(lasts) < max(3, len(alive) // 2):
            return []
        median = lasts[len(lasts) // 2]
        actions = []
        for w in alive:
            st = self.workers[w]
            if not st.step_times:
                continue
            if st.step_times[-1] > self.cfg.straggler_factor * median:
                st.slow_streak += 1
            else:
                st.slow_streak = 0
            if st.slow_streak >= self.cfg.straggler_patience:
                actions.append({
                    "action": "backup_dispatch", "worker": w,
                    "note": "re-dispatch data shard to backup; "
                            "deterministic pipeline regenerates batch",
                })
                st.slow_streak = 0
        return actions
