"""The port's CUDA-graph layer (``repro_torch/cuda_graph.py``): the state
plumbing that a captured engine round relies on, the launch counts that a
replay must keep true, and (on a card only) graphed runs against eager
ones.

A graph replays no wrapper call, so each replay adds the launches that
its graph recorded at capture; the capture itself adds none. The CPU
tests drive that bookkeeping with a stand-in for the graph; the card
tests capture the real engine round and decode step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, cuda_graph
from repro_torch.core import engine as te
from repro_torch.core import types as tt
from repro_torch.kernels import build
from repro_torch.workloads import MixedReadWrite
from port_threads import one_torch_thread  # noqa: F401

SMALL = dict(num_sqs=8, sq_depth=64, fetch_width=16)


@dataclasses.dataclass(frozen=True)
class Inner:
    a: torch.Tensor
    b: None


@dataclasses.dataclass(frozen=True)
class Outer:
    x: torch.Tensor
    inner: Inner


def tree(*vals):
    return Outer(torch.tensor(vals[0]), Inner(torch.tensor(vals[1]), None))


def test_map_leaves_keeps_the_structure_and_none():
    out = cuda_graph.map_leaves(lambda u, v: u + v, tree([1.0], [2.0, 3.0]),
                                tree([10.0], [20.0, 30.0]))
    assert isinstance(out, Outer) and out.inner.b is None
    assert out.x.tolist() == [11.0] and out.inner.a.tolist() == [22.0, 33.0]
    assert [t.tolist() for t in cuda_graph.leaves(out)] == [[11.0],
                                                            [22.0, 33.0]]


@pytest.mark.parametrize("bad", [
    tree([1.0, 2.0], [2.0, 3.0]),                      # shape
    Outer(torch.tensor([1], dtype=torch.int32),
          Inner(torch.tensor([2.0, 3.0]), None)),      # dtype
])
def test_copy_into_writes_in_place_and_refuses_a_misfit(bad):
    dst = tree([0.0], [0.0, 0.0])
    keep = dst.x
    cuda_graph.copy_into(dst, tree([1.0], [2.0, 3.0]))
    assert dst.x is keep and dst.x.tolist() == [1.0]
    assert dst.inner.a.tolist() == [2.0, 3.0]
    with pytest.raises(ValueError, match="does not fit"):
        cuda_graph.copy_into(dst, bad)


def test_check_writeback_refuses_a_view_of_another_static_leaf():
    static = Outer(torch.zeros(4), Inner(torch.zeros(4), None))
    # Fresh outputs, and an output that is its own destination, are fine.
    cuda_graph.check_writeback(static, Outer(torch.ones(4), static.inner))
    with pytest.raises(RuntimeError, match="another static buffer"):
        cuda_graph.check_writeback(
            static, Outer(static.inner.a.view(4), Inner(torch.ones(4), None)))


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_count_the_launches_recorded_at_capture():
    """Launches counted while a graph is captured leave ``LAUNCHES`` and
    go to the graph; each replay adds them back once."""
    build.reset_launches()
    build.LAUNCHES["seg_scan"] = 5
    with cuda_graph._recording() as rec:
        build.LAUNCHES["seg_scan"] += 1      # what a wrapper does
        build.LAUNCHES["fused_reap"] += 2
    assert (build.LAUNCHES["seg_scan"], build.LAUNCHES["fused_reap"]) == (5, 0)
    assert rec["seg_scan"] == 1 and rec["fused_reap"] == 2
    cap = cuda_graph.Captured.__new__(cuda_graph.Captured)
    cap.graph, cap.launches = _FakeGraph(), rec
    cap.replay(3)
    assert cap.graph.replays == 3
    assert (build.LAUNCHES["seg_scan"], build.LAUNCHES["fused_reap"]) == (8, 6)
    build.reset_launches()


def test_graphs_need_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_graph.cuda_index(torch.device("cpu"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [False, True])
def test_graphed_runner_equals_eager_run_on_the_card(card, flags):
    """A small mixed drive, kernel flags off and on: the graphed
    ``make_runner`` (undonated, donated, chained) against the eager
    ``run``, bit for bit, and launches counted once a replayed round."""
    kw = dict(use_pallas=True, use_pallas_segscan=True, use_pallas_reap=True,
              use_pallas_flash=True) if flags else {}
    cfg = tt.EngineConfig(**SMALL, num_units=4, emulate_data=True, **kw)
    ssd, plat = tt.SSDConfig(), tt.PlatformModel()
    wl = MixedReadWrite(io_depth=16, read_frac=0.7)
    state = te.init_state(cfg, ssd, wl, device=card)
    before = convert.engine_state_to_numpy(state)
    eager = convert.engine_state_to_numpy(te.run(state, cfg, ssd, wl, plat, 6))
    runner = te.make_runner(cfg, ssd, wl, plat, 3, device=card)
    runner(state)
    build.reset_launches()
    runner(state)
    assert build.LAUNCHES == {k: 3 * v for k, v in
                              runner.graph.launches.items()}
    donating = te.make_runner(cfg, ssd, wl, plat, 3, donate=True, device=card)
    chained = donating(donating(te.unalias(state)))
    assert not convert.leaf_differences(
        eager, convert.engine_state_to_numpy(chained))
    assert not convert.leaf_differences(
        before, convert.engine_state_to_numpy(state))
    three = te.run(state, cfg, ssd, wl, plat, 3)
    assert not convert.leaf_differences(
        convert.engine_state_to_numpy(three),
        convert.engine_state_to_numpy(runner(state)))


@pytest.mark.cuda
def test_a_donated_result_lasts_until_the_next_call_on_the_card(card):
    """A donating runner returns its static buffers: a second call, even
    on another state, rewrites the first call's result (``unalias`` keeps
    a copy that stays)."""
    cfg = tt.EngineConfig(**SMALL, num_units=4)
    ssd, plat = tt.SSDConfig(), tt.PlatformModel()
    wl = tt.WorkloadConfig(io_depth=16)
    state = te.init_state(cfg, ssd, wl, device=card)
    donating = te.make_runner(cfg, ssd, wl, plat, 2, donate=True, device=card)
    first = donating(te.unalias(state))
    kept = te.unalias(first)
    second = donating(te.unalias(kept))
    assert second is first
    np_of = convert.engine_state_to_numpy
    assert not convert.leaf_differences(
        np_of(te.run(state, cfg, ssd, wl, plat, 4)), np_of(first))
    assert not convert.leaf_differences(
        np_of(te.run(state, cfg, ssd, wl, plat, 2)), np_of(kept))


def _small_model(card):
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get_config("gemma2-27b", smoke=True)
    params = transformer.init_model(torch.Generator(card).manual_seed(0),
                                    cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32), device=card)
    return cfg, params, toks


@pytest.mark.cuda
def test_generate_keeps_no_device_memory_between_calls_on_the_card(card):
    """Each ``generate`` owns its captured step: after the call returns,
    its graph, caches and buffers are gone, whatever the cache length."""
    from repro_torch.serving import loop

    cfg, params, toks = _small_model(card)

    def gen(n):
        out = loop.generate(cfg, params, toks, loop.ServeConfig(
            batch=2, prompt_len=40, gen_tokens=n))
        del out
        torch.cuda.synchronize(card)
        return torch.cuda.memory_allocated(card)

    base = gen(6)
    assert [gen(9), gen(12), gen(6)] == [base] * 3


@pytest.mark.cuda
def test_graphed_decode_step_equals_eager_on_the_card(card):
    from repro_torch.models import transformer
    from repro_torch.serving import loop

    cfg, params, toks = _small_model(card)
    scfg = loop.ServeConfig(batch=2, prompt_len=40, gen_tokens=6)
    got = loop.generate(cfg, params, toks, scfg, keep_logits=True)
    logits, caches = transformer.prefill(params, cfg, toks, cache_len=46)
    out, kept = [torch.argmax(logits, -1).to(torch.int32)], [logits]
    for i in range(5):
        logits, caches = transformer.decode_step(params, cfg, out[-1], caches,
                                                 40 + i)
        out.append(torch.argmax(logits, -1).to(torch.int32))
        kept.append(logits)
    assert torch.equal(got["tokens"], torch.stack(out, 1))
    for w, g in zip(kept, got["logits"]):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_make_search_replays_one_capture_on_the_card(card):
    """A ``make_search`` object captures its iteration at the first call
    and replays that capture at the next: both calls equal the eager
    search bit for bit, and inputs of another shape raise."""
    from repro_torch.apps import vector_search as vs

    cfg = vs.SearchConfig(beam_width=2, iterations=6)
    vecs, graph = vs.build_index(0, 256, cfg, card)
    queries = vs.case_queries(8, cfg.dim, 0, card)
    ssd, ecfg = vs.case_configs(256, 40e6)
    eager = vs.search(queries, vecs, graph, cfg, ssd, ecfg=ecfg,
                      graphed=False)
    searcher = vs.make_search(cfg, ssd, ecfg=ecfg)
    first = searcher(queries, vecs, graph)
    captured = searcher.captured
    second = searcher(queries, vecs, graph)
    assert searcher.captured is captured
    for got in (first, second):
        for k, v in eager.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v), k
            else:
                assert got[k] == v, k
    with pytest.raises(ValueError, match="does not fit"):
        searcher(queries[:4], vecs, graph)
