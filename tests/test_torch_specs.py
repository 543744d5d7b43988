"""The port's abstract dry-run inputs (``repro_torch.launch.specs``)
against the reference's (``repro.launch.specs``) for every runnable cell
of ``configs.cells()``: the same keys, and leaf for leaf the same tree
paths, shapes, dtypes (bf16/bfloat16, i32/int32, f32/float32) and logical
axes; the counterpart of ``tests/test_dryrun_integration.py:36-48``.

Every leaf of the port's trees is a FakeTensor of the mode it returns, on
the CPU, holding no storage. The reference's ``abstract_params`` is built
once an arch and shared by the arch's shapes.
"""
import functools

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.launch import specs
from port_threads import one_torch_thread  # noqa: F401

CELLS = [c for c in configs.cells() if configs.runnable(*c)]


def flat(tree, prefix=""):
    """(path, leaf) pairs of a tree of dicts and tuples whose leaves are
    tensors, ShapeDtypeStructs or logical-axes tuples."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)) and not jshd._is_axes(tree):
        return [kv for i, v in enumerate(tree)
                for kv in flat(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def described(tree):
    """(path, shape, dtype name) of every leaf."""
    return [(k, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for k, x in flat(tree)]


@pytest.fixture(scope="module")
def reference(monkeypatch_module):
    """The reference's ``input_specs``, its ``abstract_params`` computed
    once an arch."""
    monkeypatch_module.setattr(
        jspecs, "abstract_params",
        functools.lru_cache(maxsize=None)(jspecs.abstract_params))
    return jspecs.input_specs


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


TREES = ("params", "opt_state", "batch", "caches")
AXES = ("param_axes", "opt_axes", "batch_axes", "cache_axes")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(reference, arch, shape):
    want = reference(arch, shape)
    got = specs.input_specs(arch, shape)
    assert set(got) == set(want) | {"fake_mode"}
    assert got["shape"].__dict__ == want["shape"].__dict__
    assert got["cfg"].name == want["cfg"].name
    for key in TREES:
        if key in want:
            assert described(got[key]) == described(want[key]), key
    for key in AXES:
        if key in want:
            assert flat(got[key]) == flat(want[key]), key
    mode = got["fake_mode"]
    for key in TREES:
        for path, leaf in flat(got.get(key, {})):
            assert isinstance(leaf, FakeTensor), (key, path)
            assert leaf.fake_mode is mode and leaf.device.type == "cpu"


def test_sds_is_fake_and_names_dtypes():
    mode = specs.fake_mode()
    for name, dtype in (("bfloat16", torch.bfloat16),
                        (torch.int32, torch.int32),
                        ("float32", torch.float32)):
        x = specs.sds((3, 5), name, mode)
        assert isinstance(x, FakeTensor) and x.fake_mode is mode
        assert x.shape == (3, 5) and x.dtype == dtype
    assert specs.sds((), torch.int32, mode).shape == ()


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cache_axes_match_reference(arch):
    """Every arch's cache axes, long_500k's included (the reference's
    skip cells have caches too)."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert flat(specs.cache_axes(cfg)) == flat(jspecs.cache_axes(jcfg))
    assert specs.opt_axes(("a",)) == jspecs.opt_axes(("a",))
