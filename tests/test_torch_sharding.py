"""The port's sharding rules and supervisor against the reference's, with
no process group: ``spec_for``/``sharding_tree`` on every leaf of every
config's ``model_axes`` (full and SMOKE, the leaves' own shapes) at the
meshes (1, 1), (2, 2), (4, 2), (16, 16) and (2, 16, 16), entry for entry;
the port's ``model_axes`` equal to the reference's; ``constrain`` the
identity outside ``use_rules``; and ``Supervisor``'s decisions on the
scenarios of ``tests/test_substrate.py`` and on seeded random heartbeat
and step-time sequences.

The reference's ``spec_for`` reads only a mesh's ``axis_names`` and the
shape of its ``devices`` array, so both sides take a stand-in carrying
those (no device mesh of 512 is built).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.launch import launcher as jlauncher
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import launcher
from repro_torch.models import transformer
from port_threads import one_torch_thread  # noqa: F401

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


@dataclasses.dataclass
class StandIn:
    axis_names: tuple
    devices: np.ndarray


def standin(shape, names):
    return StandIn(names, np.zeros(shape, np.int8))


def as_tuple(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def flat(tree, prefix=""):
    """(key, leaf) pairs of a dict/tuple tree whose leaves are axes
    tuples, ShapeDtypeStructs or shardings."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flat(tree[k],
                                                        f"{prefix}/{k}")]
    if isinstance(tree, tuple) and not jshd._is_axes(tree):
        return [kv for i, v in enumerate(tree) for kv in flat(v,
                                                              f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_specs_match_reference(arch, smoke):
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    cfg = configs.get_config(arch, smoke=smoke)
    jaxes = jtr.model_axes(jcfg)
    axes = transformer.model_axes(cfg)
    assert flat(axes) == flat(jaxes)
    shapes = jax.eval_shape(lambda k: jtr.init_model(k, jcfg),
                            jax.random.PRNGKey(0))
    shape_of = dict(flat(shapes))
    for shape, names in MESHES:
        mesh = standin(shape, names)
        tree = shd.sharding_tree(axes, shd.DEFAULT_RULES, mesh, shapes)
        got = dict(flat(tree))
        unshaped = dict(flat(shd.sharding_tree(axes, shd.DEFAULT_RULES,
                                               mesh)))
        for key, ax in flat(jaxes):
            want = jshd.spec_for(ax, jshd.DEFAULT_RULES, mesh,
                                 shape_of[key].shape)
            assert as_tuple(got[key].spec) == as_tuple(want), (key, shape)
            want = jshd.spec_for(ax, jshd.DEFAULT_RULES, mesh)
            assert as_tuple(unshaped[key].spec) == as_tuple(want), key


def test_rules_and_replicated_sentinel_are_the_reference_s():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert shd.REPLICATED == jshd.REPLICATED
    mesh = standin((2, 16, 16), ("pod", "data", "model"))
    assert as_tuple(shd.spec_for(shd.REPLICATED, shd.DEFAULT_RULES,
                                 mesh)) == ()
    # The tuple fallback: 24 rows divide neither pod·data (32) nor data
    # alone (16) but pod (2); the largest member that divides binds.
    for shape in [(24,), (48,), (32,), (7,)]:
        want = jshd.spec_for(("batch",), jshd.DEFAULT_RULES, mesh, shape)
        got = shd.spec_for(("batch",), shd.DEFAULT_RULES, mesh, shape)
        assert as_tuple(got) == as_tuple(want), shape


def test_constrain_is_identity_outside_rules():
    x = torch.arange(12.0).reshape(3, 4)
    assert shd.current_context() is None
    assert shd.constrain(x, ("batch", "embed")) is x
    mesh = standin((2, 2), ("data", "model"))
    with shd.use_rules(mesh):
        assert shd.current_context() == (mesh, shd.DEFAULT_RULES)
        # A local tensor (inside a shard_map body) is left as it is.
        assert shd.constrain(x, ("batch", "embed")) is x
    assert shd.current_context() is None


def scenarios():
    """(name, n workers, config kwargs, events): the scenarios of
    tests/test_substrate.py."""
    dead = [("hb", w, 1000.0) for w in range(4)] + [
        ("fail", 1005.0)] + [("hb", w, 1020.0) for w in range(3)] + [
        ("fail", 1020.0)]
    abort = [("hb", 0, 100.0), ("hb", 1, 100.0), ("fail", 120.0)]
    straggle = []
    for _ in range(3):
        straggle += [("time", w, 1.0 if w != 2 else 2.5) for w in range(4)]
        straggle.append(("stragglers",))
    return [("dead_restarts", 4, dict(heartbeat_timeout_s=10), dead),
            ("abort", 2, dict(heartbeat_timeout_s=10), abort),
            ("straggler", 4, dict(straggler_factor=1.5,
                                  straggler_patience=2), straggle)]


def random_events(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    kw = dict(heartbeat_timeout_s=float(rng.uniform(5, 30)),
              straggler_factor=float(rng.uniform(1.1, 2.0)),
              straggler_patience=int(rng.integers(1, 4)),
              allowed_data_sizes=(8, 4, 2, 1))
    t, events = 1000.0, []
    for _ in range(60):
        t += float(rng.uniform(0, 8))
        kind = rng.integers(0, 4)
        w = int(rng.integers(0, n))
        if kind == 0:
            events.append(("hb", w, t))
        elif kind == 1:
            events.append(("time", w, float(rng.lognormal(0, 0.5))))
        elif kind == 2:
            events.append(("stragglers",))
        else:
            events.append(("fail", t))
    return n, kw, events


def replay(mod, n, kw, events):
    sup = mod.Supervisor(n, mod.SupervisorConfig(**kw))
    for w in range(n):
        sup.heartbeat(w, 1000.0)
    out = []
    for ev in events:
        if ev[0] == "hb":
            sup.heartbeat(ev[1], ev[2])
        elif ev[0] == "time":
            sup.report_step_time(ev[1], ev[2])
        elif ev[0] == "stragglers":
            out.append(sup.straggler_actions())
        else:
            out.append(sup.handle_failures(ev[1]))
    return out, sup.restarts, {w: (s.alive, s.slow_streak, s.step_times)
                               for w, s in sup.workers.items()}


@pytest.mark.parametrize("case", range(3))
def test_supervisor_scenarios_match_reference(case):
    name, n, kw, events = scenarios()[case]
    got = replay(launcher, n, kw, events)
    assert got == replay(jlauncher, n, kw, events)
    decisions = got[0]
    if name == "dead_restarts":
        assert decisions[-1]["action"] == "elastic_downsize"
        assert decisions[-1]["new_data_parallel"] == 2
    elif name == "abort":
        assert decisions[-1]["action"] == "abort"
    else:
        assert any(a["worker"] == 2 for acts in decisions for a in acts)


@pytest.mark.parametrize("seed", range(8))
def test_supervisor_random_sequences_match_reference(seed):
    n, kw, events = random_events(seed)
    assert replay(launcher, n, kw, events) == replay(jlauncher, n, kw,
                                                     events)
