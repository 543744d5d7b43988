"""Step builders (train / prefill / decode) + their sharding trees (port of
``repro/launch/steps.py``).

These are the functions the dry run (``launch/dryrun.py``) counts for
every (arch x shape x mesh) cell. The reference jits them with the
shardings and donations ``cell_step_and_shardings`` returns; the port
runs them eagerly, on one device or, under ``sharding.use_rules``, on
DTensors placed by those shardings. ``donate`` keeps the reference's
argument numbers: the train step writes the parameters, m and v in place
(``optimizer.apply_updates``) and the decode step its caches.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as specs_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.train import loop
from repro_torch.train import optimizer as opt_lib


def build_train_step(cfg: ModelConfig, ocfg=None, grad_accum: int = 1
                     ) -> Callable:
    """grad_accum > 1 microbatches over the leading batch dim: activation
    memory scales 1/grad_accum at the cost of repeating the
    per-microbatch weight all-gathers. The step is the training loop's
    (``train.loop.make_train_step``) without compressed gradients."""
    tcfg = loop.TrainConfig(grad_accum=grad_accum,
                            opt=ocfg or opt_lib.AdamWConfig())
    train_step = loop.make_train_step(cfg, tcfg)

    def step(params, opt_state, batch):
        params, opt_state, _, metrics = train_step(params, opt_state, {},
                                                   batch)
        return params, opt_state, metrics

    return step


def build_prefill_step(cfg: ModelConfig, cache_len: int) -> Callable:
    def step(params, batch):
        return transformer.prefill(
            params, cfg,
            tokens=batch.get("tokens"),
            embeds=batch.get("embeds"),
            cache_len=cache_len,
            mrope_positions=batch.get("mrope_positions"),
        )

    return step


def build_decode_step(cfg: ModelConfig) -> Callable:
    def step(params, batch, caches):
        return transformer.decode_step(
            params, cfg, batch["token"], caches, batch["pos"],
            embeds=batch.get("embeds"),
        )

    return step


def cell_step_and_shardings(arch: str, shape: str, mesh,
                            rules=shd.DEFAULT_RULES, grad_accum: int = 1,
                            mode=None):
    """Assemble (fn, args_abstract, in_shardings, donate, cfg, shape) for a
    cell. The abstract arguments are ``specs.input_specs``' FakeTensors,
    made in ``mode`` (a fresh fake mode unless given)."""
    sp = specs_lib.input_specs(arch, shape, mode)
    cfg, sh = sp["cfg"], sp["shape"]

    p_shard = shd.sharding_tree(sp["param_axes"], rules, mesh, sp["params"])
    b_shard = shd.sharding_tree(sp["batch_axes"], rules, mesh, sp["batch"])

    if sh.kind == "train":
        fn = build_train_step(cfg, grad_accum=grad_accum)
        o_shard = shd.sharding_tree(
            sp["opt_axes"], rules, mesh, sp["opt_state"]
        )
        args = (sp["params"], sp["opt_state"], sp["batch"])
        in_sh = (p_shard, o_shard, b_shard)
        donate = (0, 1)
    elif sh.kind == "prefill":
        fn = build_prefill_step(cfg, cache_len=sh.seq_len)
        args = (sp["params"], sp["batch"])
        in_sh = (p_shard, b_shard)
        donate = ()
    else:
        fn = build_decode_step(cfg)
        c_shard = shd.sharding_tree(
            sp["cache_axes"], rules, mesh, sp["caches"]
        )
        args = (sp["params"], sp["batch"], sp["caches"])
        in_sh = (p_shard, b_shard, c_shard)
        donate = (2,)
    return fn, args, in_sh, donate, cfg, sh
