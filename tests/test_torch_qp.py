"""The port's coalescing completion path (``repro_torch/core/qp.py``'s
non-neutral ``post_and_reap``) and ``segops.lex_sort_by_segment`` against
the reference (``repro/core/qp.py``, ``repro/core/segops.py``).

Per call, on one shared input CQ state (rings holding entries, per-CQ
doorbell cursors, one tail just below the int32 wrap): the port against
the *compiled* reference, which is what ``simulate`` runs, at
``cq_coalesce_n`` 1, 2, 4 and 32. The port has one CQE order; the
reference's fused sort is held against it at every size, its two sorts
at 1 and on a stack, and the doorbell queue on the ``seg_scan``
route (the port's plain version on the CPU, the reference's Pallas
kernel in interpret mode) at 1 and 32 and on a stack of two drives.
Every ring leaf, the doorbell cursors and the reaped times are
bit-exact: the reference's
compiled reap time ``posted + poll + (rank + 1) * reap`` rounds each
operation on its own here (no multiply-add contraction shows), as the
port does. Whole runs at small widths with a coalescing QP, one drive
and an array of two: every leaf equal but the metric sums (``SUM_ULP``).
Last, the port's client ring path reproduces its ``engine_round`` on the
same request stream, neutral and coalescing: completion times
bit-exact, the E2E sum within ``SUM_ULP``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads as jw
from repro.core import engine as je
from repro.core import qp as jqp
from repro.core import segops as jseg
from repro.core import types as jt
from repro_torch import convert
from repro_torch import workloads as tw
from repro_torch.core import engine as te
from repro_torch.core import frontend as tf
from repro_torch.core import qp as tqp
from repro_torch.core import segops as tseg
from repro_torch.core import types as tt
from repro_torch.core.client import StorageClient as TClient
from port_threads import one_torch_thread  # noqa: F401

SMALL = dict(num_sqs=8, sq_depth=64, fetch_width=16)
SUM_ULP = 16
SUM_BOUNDS = {k: SUM_ULP for k in (
    "metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc",
    "metrics.tenant_sum_e2e")}
# Fig 21's QP with the coalescing count left open.
FIG21_QP = dict(cq_coalesce_us=50.0, cq_doorbell_us=1.0, cq_poll_us=0.3,
                cqe_reap_us=0.02)


def jleaves(state):
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def same(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(got.view(np.int32) if got.dtype.kind == "f"
                                  else got,
                                  want.view(np.int32) if want.dtype.kind
                                  == "f" else want)


def vmapped(fn, lead):
    for _ in lead:
        fn = jax.vmap(fn)
    return jax.jit(fn)


# -- lex_sort_by_segment -------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "stack3"])
def test_lex_sort_by_segment_matches_reference(lead):
    """Keys with long runs, times with many ties, and one segment holding
    both -0.0 and +0.0, which the reference's ``lax.sort`` holds equal:
    the zeros keep their row order."""
    rng = np.random.default_rng(11)
    n = 300
    key = rng.integers(0, 6, lead + (n,)).astype(np.int32)
    t = rng.integers(0, 20, lead + (n,)).astype(np.float32) * np.float32(0.5)
    key[..., :8] = 2
    t[..., :8] = np.array([0.0, -0.0, 1.5, -0.0, 0.0, 1.5, -0.0, 0.0],
                          np.float32)
    want = vmapped(jseg.lex_sort_by_segment, lead)(jnp.asarray(key),
                                                   jnp.asarray(t))
    got = tseg.lex_sort_by_segment(torch.from_numpy(key), torch.from_numpy(t))
    for w, g in zip(want, got):
        same(w, g)
    first = got[0].numpy().reshape(-1, n)[0]
    zeros = [i for i in first if i < 8 and t.reshape(-1, n)[0][i] == 0.0]
    assert zeros == [0, 1, 3, 4, 6, 7]


# -- post_and_reap, one call on a shared state ---------------------------------

Q, D, N = 8, 64, 512


def cq_inputs(seed, lead=()):
    """A CQ state with entries and doorbell cursors, one tail at the int32
    wrap, and an epoch of N completions (a fifth invalid, done 0)."""
    rng = np.random.default_rng(seed)
    state = dict(
        done_time=(rng.random(lead + (Q, D)) * 200).astype(np.float32),
        visible_time=(rng.random(lead + (Q, D)) * 200).astype(np.float32),
        req_id=rng.integers(0, 1 << 20, lead + (Q, D)).astype(np.int32),
        head=rng.integers(0, 5000, lead + (Q,)).astype(np.int32),
        tail=rng.integers(0, 5000, lead + (Q,)).astype(np.int32),
        bell_time=(rng.random(lead + (Q,)) * 400).astype(np.float32),
    )
    state["tail"][..., 3] = 2 ** 31 - 40
    valid = rng.random(lead + (N,)) < 0.8
    done = np.where(valid, rng.random(lead + (N,)) * 600 + 20, 0).astype(
        np.float32)
    done[..., 10:20] = done[..., 9:10]          # equal completion times
    cq_id = rng.integers(0, Q, lead + (N,)).astype(np.int32)
    req = rng.integers(0, 1 << 20, lead + (N,)).astype(np.int32)
    return state, (cq_id, done, req, valid)


@pytest.mark.parametrize("n_coal, lead", [
    (1, ()), (2, ()), (4, ()), (32, ()), (4, (2,))],
    ids=["1", "2", "4", "32", "4-stack2"])
def test_post_and_reap_matches_compiled_reference(n_coal, lead):
    state, rows = cq_inputs(n_coal, lead)
    jcq = jqp.CQRings(**{k: jnp.asarray(v) for k, v in state.items()})
    tcq = tqp.CQRings(**{k: torch.from_numpy(v) for k, v in state.items()})
    jcfg = jt.QPConfig(cq_coalesce_n=n_coal, **FIG21_QP)
    tcfg = tt.QPConfig(cq_coalesce_n=n_coal, **FIG21_QP)
    # The port has one CQE order. The reference's fused sort (its default,
    # ``use_sort_plan``) is held against it at every size, its two-sort
    # branch at one completion a doorbell and on the stack; the seg_scan
    # route at the extremes of the group size and on the stack.
    variants = [(True, False)]
    if n_coal == 1 or lead:
        variants.append((False, False))
    if n_coal in (1, 32) or lead:
        variants.append((True, True))
    for fused_sort, pallas in variants:
        want_cq, want = vmapped(
            lambda c, a, b, r, v: jqp.post_and_reap(
                c, a, b, r, v, jcfg, fused_sort=fused_sort,
                use_pallas=pallas), lead)(jcq, *map(jnp.asarray, rows))
        got_cq, got = tqp.post_and_reap(
            tcq, *map(torch.from_numpy, rows), tcfg, use_pallas=pallas)
        same(want, got)
        for f in dataclasses.fields(got_cq):
            same(getattr(want_cq, f.name), getattr(got_cq, f.name))
    # The coalescing really reorders and delays: reaped times are not the
    # done times.
    valid = rows[3]
    assert (got.numpy()[valid] > rows[1][valid]).all()
    for k, v in state.items():        # the input state is left as it was
        np.testing.assert_array_equal(getattr(tcq, k).numpy(), v)


# -- whole runs ----------------------------------------------------------------

RUNS = {
    "read_coal4": (4, jt.WorkloadConfig(io_depth=16),
                   tt.WorkloadConfig(io_depth=16)),
    "mixed_coal1": (1, jw.MixedReadWrite(io_depth=16, read_frac=0.7),
                    tw.MixedReadWrite(io_depth=16, read_frac=0.7)),
}


@pytest.mark.parametrize("name, m", [("read_coal4", 1), ("mixed_coal1", 2)])
def test_coalescing_simulate_matches_reference(name, m):
    """Six rounds with fig 21's QP: 4 completions a doorbell under reads on
    one drive, 1 under a 70/30 mix on an array of two. Every leaf equal
    (the CQ rings, doorbell cursors and histograms among them) but the
    metric sums."""
    n_coal, wj, wt = RUNS[name]
    cj = jt.EngineConfig(**SMALL, qp=jt.QPConfig(cq_coalesce_n=n_coal,
                                                 **FIG21_QP))
    ct = tt.EngineConfig(**SMALL, qp=tt.QPConfig(cq_coalesce_n=n_coal,
                                                 **FIG21_QP))
    rounds = 6
    if m == 1:
        ref = je.make_runner(cj, jt.SSDConfig(), wj, jt.PlatformModel(),
                             rounds)(je.init_state(cj, jt.SSDConfig(), wj))
    else:
        ref = je.simulate(cj, jt.SSDConfig(), wj, rounds=rounds,
                          num_devices=m)
    out = te.simulate(ct, tt.SSDConfig(), wt, rounds=rounds, num_devices=m,
                      device="cpu")
    want, got = jleaves(ref), convert.engine_state_to_numpy(out)
    assert float(want["metrics.completed"].min()) > 0
    assert float(want["cq.bell_time"].max()) > 0
    assert not convert.leaf_differences(want, got, SUM_BOUNDS)


# -- the port's client ring path against its engine round ---------------------

RING_QPS = {
    "qp0": tt.QPConfig(),
    "qp1": tt.QPConfig(cq_coalesce_n=4, cq_coalesce_us=40.0,
                       cq_doorbell_us=0.5, cq_poll_us=0.3, cqe_reap_us=0.05),
}


@pytest.mark.parametrize("name", sorted(RING_QPS))
def test_client_ring_path_reproduces_engine_round(name):
    """The reference's own ring-path test, on the port: 256 reads through
    ``StorageClient.read`` and the same per-SQ stream through one
    ``engine_round``. The completion times agree bit for bit; the E2E sum
    within SUM_ULP of the client's (the two add the same terms in other
    orders, which is also why the reference's own test, which asks for
    the float32 sums to be equal, fails by one ULP: ROADMAP §C)."""
    ssd = tt.SSDConfig(t_max_iops=2.47e6, l_min_us=50.0, n_instances=64,
                       num_blocks=1 << 12)
    cfg = tt.EngineConfig(num_sqs=8, sq_depth=256, fetch_width=64,
                          num_units=4, emulate_data=False, num_bufs=512,
                          qp=RING_QPS[name])
    plat = tt.PlatformModel()
    n, t0 = 256, 2.0
    lba = (torch.arange(n, dtype=torch.int32) * 37) % ssd.num_blocks
    client = TClient(ssd, cfg, plat)
    _, _, done = client.read(client.init_state("cpu"),
                             torch.ones((ssd.num_blocks, 8)), lba, t0)

    q = cfg.num_sqs
    sq = tf.deal_sqs(n, cfg, "cpu").numpy()
    order = np.lexsort((np.arange(n), sq))
    per_sq = [list(order[sq[order] == s]) for s in range(q)]
    trace_idx = np.array([per_sq[j % q][j // q] for j in range(n)])
    wl = tw.TraceReplay.from_trace(np.full(n, t0, np.float32),
                                   lba.numpy()[trace_idx], np.zeros(n), cfg)
    st = te.init_state(cfg, ssd, wl, device="cpu")
    st = dataclasses.replace(st, clock=torch.tensor(t0, dtype=torch.float32))
    m = te.engine_round(st, cfg, ssd, wl, plat).metrics

    assert float(m.completed) == n
    assert float(m.last_completion) == float(torch.amax(done))
    e2e = done - t0
    client_sum = np.float32(e2e.double().sum())
    assert convert.ulp_distance(m.sum_e2e.numpy(), client_sum) <= SUM_ULP
    np.testing.assert_array_equal(
        np.bincount(te.latency_bucket(e2e).numpy(), minlength=64),
        m.lat_hist.numpy().astype(int))
    if name == "qp1":
        assert float(torch.amax(done)) > float(torch.amax(
            client_done_neutral(ssd, cfg, plat, lba, t0)))


def client_done_neutral(ssd, cfg, plat, lba, t0):
    client = TClient(ssd, cfg.replace(qp=tt.QPConfig()), plat)
    return client.read(client.init_state("cpu"),
                       torch.ones((ssd.num_blocks, 8)), lba, t0)[2]
