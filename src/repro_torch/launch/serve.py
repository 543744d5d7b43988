"""Serving command: batched prefill + decode with the SSD-backed KV tier
(port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
        --iops 40e6 [--smoke] [--gen 16] [--device cuda]

Runs on the card unless ``--device cpu`` is given. ``setup`` builds the
objects the command drives; ``chip_smoke.py`` drives the same objects.
"""
from __future__ import annotations

import argparse

PARAM_SEED = 0   # stands in for the reference's PRNGKey(0)
TOKEN_SEED = 1   # stands in for PRNGKey(1)


def setup(arch: str, smoke: bool = False, batch: int = 4, prompt: int = 32,
          gen: int = 16, iops: float = 2.5e6, device: str = "cuda"):
    """(cfg, params, tokens, ssd, scfg) of one serving run: random
    parameters and prompt tokens from seeded generators on ``device``,
    the drive at ``iops``, the tier at 16 hot tokens in 8-token pages."""
    import torch

    from repro_torch import configs
    from repro_torch.core.types import SSDConfig, resolve_device
    from repro_torch.models import transformer
    from repro_torch.serving import loop as serve_loop
    from repro_torch.serving.kv_tier import KVTierConfig

    device = resolve_device(device)
    cfg = configs.get_config(arch, smoke=smoke)
    params = transformer.init_model(
        torch.Generator(device=device).manual_seed(PARAM_SEED), cfg
    )
    tokens = torch.randint(
        0, cfg.vocab, (batch, prompt), dtype=torch.int32, device=device,
        generator=torch.Generator(device=device).manual_seed(TOKEN_SEED),
    )
    ssd = SSDConfig(
        t_max_iops=iops,
        n_instances=max(64, int(iops // 4e4)), num_blocks=1 << 14,
    )
    scfg = serve_loop.ServeConfig(
        batch=batch, prompt_len=prompt, gen_tokens=gen,
        tier=KVTierConfig(hot_window=16, page_tokens=8),
    )
    return cfg, params, tokens, ssd, scfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--iops", type=float, default=2.5e6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.serving import loop as serve_loop

    cfg, params, tokens, ssd, scfg = setup(
        args.arch, args.smoke, args.batch, args.prompt, args.gen, args.iops,
        args.device,
    )
    out = serve_loop.serve_with_kv_tier(cfg, params, tokens, scfg, ssd)
    print(f"arch={cfg.name} generated {args.gen} tokens x {args.batch} seqs "
          f"on {tokens.device}")
    print(f"virtual tokens/s (SSD KV tier @ {args.iops/1e6:.1f} MIOPS): "
          f"{out['tokens_per_s']:.1f}")
    print(f"avg step {out['avg_step_us']:.1f} us "
          f"(storage {out['avg_storage_us']:.1f} us, "
          f"{out['blocks_per_step']} block faults/step, "
          f"demand {out['iops_demand']/1e6:.2f} MIOPS)")
    print(f"wall-clock: prefill {out['prefill_s']:.3f}s, decode "
          f"{out['wall_s']:.3f}s on {tokens.device}")
    return out


if __name__ == "__main__":
    main()
