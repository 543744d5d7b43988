"""Carry engine state and model parameters between the reference and
the port.

A state is exchanged as a flat dict of numpy arrays keyed by the
reference's pytree paths, e.g. ``"device.tstate.busy_until"`` (the field
names of the two packages' dataclasses are the same, so the paths are
too). Dtypes and shapes pass through unchanged: float32, int32 and bool,
and an M-drive array's leading ``(M,)`` axis on every leaf. The optional
page cache (``cache.tags``, ``cache.rr``) travels when it is there and is
``None`` when its leaves are not; a remote drive's fabric cursors
(``device.fabric.*``, one per tenant class) and the per-tenant metrics
travel as every other leaf does. Engine states
(``EngineState``) and client states (``ClientState``) go both ways. Model
parameters are exchanged as the reference's own nested tree of dicts and
tuples with numpy leaves, both ways (``model_params_from_numpy``,
``model_params_to_numpy``), and so is AdamW's state
(``opt_state_from_numpy``, ``opt_state_to_numpy``).
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Dict

import numpy as np
import torch

from repro_torch.core.client import ClientState
from repro_torch.core.engine import EngineState
from repro_torch.models.config import ModelConfig


def _collect(obj, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        path = prefix + f.name
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            _collect(v, path + ".", out)
        else:
            out[path] = v.detach().cpu().numpy()


def _build(cls, leaves: Dict[str, np.ndarray], prefix: str, device):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        t = hints[f.name]
        path = prefix + f.name
        opt = [a for a in typing.get_args(t) if a is not type(None)]
        if len(opt) == 1 and type(None) in typing.get_args(t):
            # An optional sub-state (the page cache): present when its
            # leaves are.
            t = opt[0] if any(k.startswith(path + ".") for k in leaves) \
                else type(None)
        if dataclasses.is_dataclass(t):
            kw[f.name] = _build(t, leaves, path + ".", device)
        elif t is type(None):
            kw[f.name] = None
        else:
            arr = np.array(leaves[path], copy=True, order="C")
            kw[f.name] = torch.from_numpy(arr).to(device)
    return cls(**kw)


def engine_state_to_numpy(
    state: "EngineState | ClientState",
) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` (an engine or a client state, one drive's
    or an array's) as a numpy array, keyed by its path."""
    out: Dict[str, np.ndarray] = {}
    _collect(state, "", out)
    return out



def ulp_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place between two
    arrays (0 for bit-identical ones; +0 and -0 are 0 apart)."""
    def key(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(key(a) - key(b)).max()) if np.size(a) else 0


def leaf_differences(
    ref: Dict[str, np.ndarray],
    port: Dict[str, np.ndarray],
    ulp_bounds: "Dict[str, int] | None" = None,
) -> list:
    """Describe every leaf where ``port`` breaks its contract with ``ref``:
    a missing leaf, another dtype or shape, an integer or bool leaf that is
    not equal, or a float leaf more than ``ulp_bounds.get(path, 0)`` ULP
    away. An empty list means the two states agree."""
    bounds = ulp_bounds or {}
    out = []
    for path in sorted(set(ref) | set(port)):
        if path not in ref or path not in port:
            out.append(f"{path}: only in one state")
            continue
        a, b = ref[path], port[path]
        if a.dtype != b.dtype or a.shape != b.shape:
            out.append(f"{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        elif a.dtype.kind == "f":
            u = ulp_distance(a, b)
            if u > bounds.get(path, 0):
                out.append(f"{path}: {u} ULP (bound {bounds.get(path, 0)})")
        elif not np.array_equal(a, b):
            out.append(f"{path}: {int(np.sum(a != b))} entries differ")
    return out


def engine_state_from_numpy(
    leaves: Dict[str, np.ndarray], device: "torch.device | str"
) -> EngineState:
    """The port's ``EngineState`` on ``device`` from path-keyed leaves
    (the inverse of ``engine_state_to_numpy``). A missing leaf raises
    ``KeyError`` naming its path."""
    return _build(EngineState, leaves, "", torch.device(device))


def client_state_from_numpy(
    leaves: Dict[str, np.ndarray], device: "torch.device | str"
) -> ClientState:
    """The port's ``ClientState`` on ``device`` from path-keyed leaves
    (``"dev.tstate.busy_until"``, ...), one drive's or an array's."""
    return _build(ClientState, leaves, "", torch.device(device))


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, bit for bit; numpy has no bfloat16 of its own, so
    the ``ml_dtypes`` bfloat16 arrays the reference hands out travel as
    their 16-bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


# Leaves that stay float32 in a model of any dtype, as the reference's
# initializers make them: the MoE router and shared-expert gate, RG-LRU's
# Λ, and the sLSTM/mLSTM gate biases and sLSTM's recurrent weights.
FLOAT32_LEAVES = ("router", "shared_gate", "lambda_", "b_if", "b_in",
                  "w_rec")


def model_params_from_numpy(tree, cfg: ModelConfig, device) -> dict:
    """The port's parameters on ``device`` from the reference's
    ``transformer.init_model`` tree with numpy leaves (same keys, same
    stacking per pattern member, same layouts). Every leaf has the
    config's dtype but those named in ``FLOAT32_LEAVES``, which are
    float32. Raises ``ValueError`` when the tree does not fit ``cfg``."""
    if len(tree["periods"]) != len(cfg.pattern) or len(
        tree["remainder"]
    ) != len(cfg.remainder):
        raise ValueError(f"parameter tree does not match {cfg.name}'s "
                         "layer pattern")

    def conv(node, stacked: bool, name: str = ""):
        if isinstance(node, dict):
            return {k: conv(v, stacked, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v, stacked) for v in node)
        a = np.asarray(node)
        want = "float32" if name in FLOAT32_LEAVES else cfg.dtype
        if a.dtype.name != want:
            raise ValueError(f"leaf {name or '?'} of dtype {a.dtype.name}, "
                             f"want {want}")
        if stacked and a.shape[0] != cfg.n_periods:
            raise ValueError(f"stacked leaf {a.shape} lacks the "
                             f"{cfg.n_periods} periods")
        return _tensor(a, device)

    device = torch.device(device)
    return {k: conv(v, k == "periods") for k, v in tree.items()}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy, bit for bit; bfloat16 as ``ml_dtypes``' bfloat16
    (the reference's own numpy type for it, present wherever JAX is)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def model_params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The reference's ``init_model`` tree (dicts, and tuples for
    ``periods`` and ``remainder``) with numpy leaves from the port's
    parameters: the inverse of ``model_params_from_numpy``."""
    if len(params["periods"]) != len(cfg.pattern):
        raise ValueError(f"parameters do not match {cfg.name}'s pattern")

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        return _numpy(node)

    return conv(params)


def opt_state_to_numpy(state: dict, cfg: ModelConfig) -> dict:
    """AdamW's ``{m, v, step}`` as the reference's tree with numpy
    leaves (m and v float32 trees of the parameters' shape, step an int32
    scalar)."""
    return {"m": model_params_to_numpy(state["m"], cfg),
            "v": model_params_to_numpy(state["v"], cfg),
            "step": _numpy(state["step"])}


def opt_state_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The port's AdamW state on ``device`` from the reference's
    ``{m, v, step}`` with numpy leaves; m and v must be float32 and step
    int32."""
    device = torch.device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        a = np.asarray(node)
        if a.dtype != np.float32:
            raise ValueError(f"m/v leaf of dtype {a.dtype.name}, want "
                             "float32")
        return _tensor(a, device)

    step = np.asarray(tree["step"])
    if step.dtype != np.int32 or step.shape != ():
        raise ValueError(f"step: {step.dtype}{step.shape}, want an int32 "
                         "scalar")
    if len(tree["m"]["periods"]) != len(cfg.pattern):
        raise ValueError(f"state does not match {cfg.name}'s pattern")
    return {"m": conv(tree["m"]), "v": conv(tree["v"]),
            "step": _tensor(step, device)}


def search_inputs_from_numpy(vecs, graph, queries, device
                             ) -> "tuple[torch.Tensor, ...]":
    """A vector-search index and its queries on ``device``, bit for bit:
    the reference's ``build_index`` vectors (N, D) float32 and graph
    (N, degree) int32, and its (B, D) float32 queries, as numpy arrays.
    Raises ``ValueError`` on another dtype or a mismatched shape."""
    vecs, graph, queries = (np.asarray(a) for a in (vecs, graph, queries))
    for name, a, want in (("vecs", vecs, np.float32),
                          ("graph", graph, np.int32),
                          ("queries", queries, np.float32)):
        if a.dtype != want or a.ndim != 2:
            raise ValueError(f"{name}: {a.dtype}{a.shape}, want a 2-D "
                             f"{np.dtype(want).name} array")
    if graph.shape[0] != vecs.shape[0] or queries.shape[1] != vecs.shape[1]:
        raise ValueError(f"shapes do not fit: vecs {vecs.shape}, graph "
                         f"{graph.shape}, queries {queries.shape}")
    device = torch.device(device)
    return tuple(_tensor(a, device) for a in (vecs, graph, queries))
