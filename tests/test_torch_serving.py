"""The port's serving path against the reference: ``StorageOps``, the
frontend's flat submit, ``StorageClient.submit``, the paged KV cache, the
SSD-backed KV tier and the serving loop.

Integer bookkeeping (ring slots, page tables, block counts) must match
exactly, and so must the block store and every gathered byte. Virtual
times are held to ``TIME_ULP``, 0 since the port's timing core fuses the
reference's compiled multiply-adds; the tier's aggregate timing stats
must agree within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import frontend as jfront
from repro.core import types as jtypes
from repro.core.client import StorageClient as JClient
from repro.models import transformer as jtr
from repro.serving import kv_tier as jtier
from repro.serving import loop as jloop
from repro.serving import paged_kv as jpk
from repro_torch import configs, convert
from repro_torch.convert import ulp_distance
from repro_torch.core import frontend, types
from repro_torch.core.client import StorageClient
from repro_torch.launch import serve
from repro_torch.serving import kv_tier, loop
from repro_torch.serving import paged_kv as pk
from port_threads import one_torch_thread  # noqa: F401

SSD = dict(t_max_iops=1e6, l_min_us=20.0, n_instances=32, num_blocks=1 << 12)
ECFG = dict(num_units=4, fetch_width=64)
TIME_ULP = 0   # completion times (the timing core fuses as XLA does)


def t(x):
    return torch.from_numpy(np.array(x))


def same(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(got, want)


def leaves(obj, prefix=""):
    """Path -> numpy leaf of a state dataclass of either package."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(leaves(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = np.asarray(v)
    return out


def test_storage_ops_make_and_concat_match_reference():
    lba = np.arange(6, dtype=np.int32)
    valid = np.array([1, 0, 1, 1, 0, 1], bool)
    want = jtypes.StorageOps.make(jnp.asarray(lba), 2.5, opcode=1, tenant=3,
                                  valid=jnp.asarray(valid))
    got = types.StorageOps.make(t(lba), 2.5, opcode=1, tenant=3,
                                valid=t(valid))
    both = (want.concat(jtypes.StorageOps.make(jnp.asarray(lba[:2]))),
            got.concat(types.StorageOps.make(t(lba[:2]))))
    for w, g in ((want, got), both):
        for f in dataclasses.fields(w):
            same(getattr(w, f.name), getattr(g, f.name))
    assert got.capacity == 6


def test_frontend_submit_and_deal_sqs_match_reference():
    rng = np.random.default_rng(0)
    cfg_j = jtypes.EngineConfig(num_sqs=8, sq_depth=16, fetch_width=4,
                                num_units=2)
    cfg_t = types.EngineConfig(num_sqs=8, sq_depth=16, fetch_width=4,
                               num_units=2)
    same(jfront.deal_sqs(37, cfg_j), frontend.deal_sqs(37, cfg_t, "cpu"))
    rj = jfront.SQRings.empty(8, 16)
    rt = frontend.SQRings.empty(8, 16, "cpu")
    submit_j = jax.jit(jfront.submit)
    for rnd in range(3):
        n = 40
        cols = [rng.integers(0, 8, n).astype(np.int32),
                np.sort(rng.uniform(0, 50, n)).astype(np.float32)]
        cols += [rng.integers(0, 1000, n).astype(np.int32) for _ in range(5)]
        valid = rng.random(n) < 0.7
        tenant = rng.integers(0, 3, n).astype(np.int32)
        rj = submit_j(rj, *map(jnp.asarray, cols), jnp.asarray(valid),
                      tenant=jnp.asarray(tenant))
        rt = frontend.submit(rt, *map(t, cols), t(valid), tenant=t(tenant))
        for f in dataclasses.fields(rj):
            same(getattr(rj, f.name), getattr(rt, f.name))


def client_case(n, seed, writes=True):
    rng = np.random.default_rng(seed)
    lba = rng.permutation(1 << 13)[:n].astype(np.int32)
    t_sub = np.round(rng.uniform(0, 300, n), 1).astype(np.float32)
    op = (rng.random(n) < (0.4 if writes else 0.0)).astype(np.int32)
    tenant = rng.integers(0, 2, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    flash = rng.standard_normal((1 << 13, 8)).astype(np.float32)
    data = rng.standard_normal((n, 8)).astype(np.float32)
    return lba, t_sub, op, tenant, valid, flash, data


@pytest.mark.parametrize("n,writes,with_payload", [
    (300, False, False), (2500, True, True),
])
def test_client_submit_matches_reference(n, writes, with_payload):
    """One submit from a fresh state and a second from the first's state
    (the second batch takes several fetch passes): completion times within
    the ULP bound, every integer leaf and the block store exact."""
    lba, t_sub, op, tenant, valid, flash, data = client_case(n, n, writes)
    ssd_j, ssd_t = jtypes.SSDConfig(**SSD), types.SSDConfig(**SSD)
    cj = JClient(ssd_j, jtypes.EngineConfig(**ECFG))
    ct = StorageClient(ssd_t, types.EngineConfig(**ECFG))
    sj, st = cj.init_state(), ct.init_state("cpu")
    submit_j = jax.jit(lambda s, f, o, d: cj.submit(s, f, o, data=d,
                                                    with_data=True))
    fj, ft = jnp.asarray(flash), t(flash)
    payload = (jnp.asarray(data), t(data)) if with_payload else (None, None)
    for shift in (0.0, 400.0):
        opj = jtypes.StorageOps.make(jnp.asarray(lba), jnp.asarray(t_sub + shift),
                                     opcode=jnp.asarray(op),
                                     tenant=jnp.asarray(tenant),
                                     valid=jnp.asarray(valid))
        opt = types.StorageOps.make(t(lba), t(t_sub + shift), opcode=t(op),
                                    tenant=t(tenant), valid=t(valid))
        sj, fj, oj, dj = submit_j(sj, fj, opj, payload[0])
        st, ft, ot, dt = ct.submit(st, ft, opt, data=payload[1],
                                   with_data=True)
        assert ulp_distance(np.asarray(dj), dt.numpy()) <= TIME_ULP
        same(fj, ft)
        same(oj, ot)
        want, got = leaves(sj.dev), leaves(st.dev)
        assert want.keys() == got.keys()
        for k in want:
            if want[k].dtype.kind == "f":
                assert ulp_distance(want[k], got[k]) <= TIME_ULP, k
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_client_refuses_what_it_cannot_price():
    ct = StorageClient(types.SSDConfig(**SSD),
                       types.EngineConfig(num_sqs=2, sq_depth=8,
                                          fetch_width=4, num_units=1))
    ops = types.StorageOps.make(torch.arange(17, dtype=torch.int32))
    with pytest.raises(ValueError, match="exceeds ring capacity"):
        ct.submit(ct.init_state("cpu"), torch.zeros(64, 4), ops)
    # The page cache is ported: a cached client starts empty and serves a
    # re-read at hit_us without posting it.
    cached = StorageClient(types.SSDConfig(**SSD), types.EngineConfig(
        cache=types.CacheConfig(enabled=True)))
    st = cached.init_state("cpu")
    assert st.cache.tags.shape == (512, 4) and bool((st.cache.tags == -1).all())
    lba = torch.arange(8, dtype=torch.int32)
    flash = torch.zeros(64, 4)
    st, _, first = cached.read(st, flash, lba, 10.0)
    st, _, again = cached.read(st, flash, lba, 1000.0)
    assert bool((first > 10.5).all())
    assert again.tolist() == [1000.5] * 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kv_matches_reference(dtype):
    pj = jpk.PagedKVConfig(page_tokens=4, n_pages=24, max_pages=8,
                           kv_heads=2, head_dim=8, dtype=dtype)
    pt = pk.PagedKVConfig(**dataclasses.asdict(pj))
    kj, kt = jpk.init_paged(pj, 3), pk.init_paged(pt, 3, "cpu")
    rng = np.random.default_rng(1)
    for _ in range(19):
        k = rng.standard_normal((3, 2, 8)).astype(np.float32)
        v = rng.standard_normal((3, 2, 8)).astype(np.float32)
        kj = jpk.append_token(kj, pj, jnp.asarray(k).astype(dtype),
                              jnp.asarray(v).astype(dtype))
        kt = pk.append_token(kt, pt, t(k).to(getattr(torch, dtype)),
                             t(v).to(getattr(torch, dtype)))
    for f in ("page_table", "lengths", "free_head"):
        same(getattr(kj, f), getattr(kt, f))
    for f in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(
            getattr(kt, f).float().numpy(),
            np.asarray(getattr(kj, f)).astype(np.float32))
    for w, g in zip(jpk.gather_dense(kj, pj), pk.gather_dense(kt, pt)):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))
    assert jpk.page_blocks(pj) == pk.page_blocks(pt)
    assert jpk.page_blocks(pj, 64) == pk.page_blocks(pt, 64)
    for hot in (0, 1, 3):
        same(jpk.cold_page_mask(kj, pj, hot), pk.cold_page_mask(kt, pt, hot))
    same(jpk.page_run_lbas(kj.page_table, 3), pk.page_run_lbas(kt.page_table, 3))
    same(jpk.pack_pages(kj, pj, 24), pk.pack_pages(kt, pt, 24))


def test_fault_pages_virtual_time_matches_reference():
    pj = jpk.PagedKVConfig(page_tokens=4, n_pages=16, max_pages=8,
                           kv_heads=2, head_dim=32, dtype="float32")
    pt = pk.PagedKVConfig(**dataclasses.asdict(pj))
    kj, kt = jpk.init_paged(pj, 2), pk.init_paged(pt, 2, "cpu")
    for i in range(23):
        x = np.full((2, 2, 32), i, np.float32)
        kj = jpk.append_token(kj, pj, jnp.asarray(x), jnp.asarray(x))
        kt = pk.append_token(kt, pt, t(x), t(x))
    cj = JClient(jtypes.SSDConfig(**SSD), jtypes.EngineConfig(**ECFG))
    ct = StorageClient(types.SSDConfig(**SSD), types.EngineConfig(**ECFG))
    flash = np.zeros((1 << 10, 4), np.float32)
    _, dj = jax.jit(lambda kv, st, f: jpk.fault_pages_virtual_time(
        kv, pj, cj, st, f, 5.0))(kj, cj.init_state(), jnp.asarray(flash))
    _, dt = pk.fault_pages_virtual_time(kt, pt, ct, ct.init_state("cpu"),
                                        t(flash), 5.0)
    assert ulp_distance(np.asarray(dj), dt.numpy()) <= TIME_ULP


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma2-27b", "yi-34b"])
def test_tier_sizing_matches_reference(arch):
    """The analytic sizing helpers at full width, f32 and bf16 pages."""
    for tier_kw in ({}, dict(hot_window=16, page_tokens=8)):
        tj, tt = jtier.KVTierConfig(**tier_kw), kv_tier.KVTierConfig(**tier_kw)
        for dtype in ("bfloat16", "float32"):
            cj = jconfigs.get_config(arch).replace(dtype=dtype)
            ct = configs.get_config(arch).replace(dtype=dtype)
            assert kv_tier.kv_page_blocks(ct, tt) == jtier.kv_page_blocks(cj, tj)
            for n in (0, 48, 4224):
                assert kv_tier.cold_blocks_per_step(ct, tt, n) == \
                    jtier.cold_blocks_per_step(cj, tj, n)
            pj = jtier.paged_cfg_for(cj, tj, 4, 32, 16)
            assert dataclasses.asdict(kv_tier.paged_cfg_for(ct, tt, 4, 32, 16)
                                      ) == dataclasses.asdict(pj)
            assert tt.hot_pages == tj.hot_pages
            assert kv_tier.region_block_values(
                pk.PagedKVConfig(**dataclasses.asdict(pj)), tt
            ) == jtier.region_block_values(pj, tj)


TIER = dict(page_tokens=4, hot_window=8, gpu_step_us=20.0)
SLOW = dict(t_max_iops=2e5, l_min_us=20.0, n_instances=32, num_blocks=1 << 14)
FAST = dict(SLOW, t_max_iops=4e6)


def check_stats(want, got):
    for key in ("blocks_per_step", "hot_pages", "data_check_max_abs"):
        assert got[key] == want[key], key
    for key in ("tokens_per_s", "avg_step_us", "avg_storage_us",
                "iops_demand"):
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=0), key
    assert got["data_check_max_abs"] == 0.0


@pytest.mark.parametrize("ssd, cache", [
    (SLOW, {}), (SLOW, dict(enabled=True, num_sets=16, ways=2, readahead=2)),
], ids=["slow", "slow_cached"])
def test_decode_tokens_per_s_matches_reference(ssd, cache):
    """tests/test_serving_loop.py's sizes: yi-34b smoke, batch 2, a
    16-token prompt, 4 decode steps (the fast drive runs in
    test_serve_with_kv_tier_matches_reference); and with a small page
    cache in front of the faults (fig 28's readahead)."""
    want = jtier.decode_tokens_per_s(
        jconfigs.get_config("yi-34b", smoke=True), jtier.KVTierConfig(**TIER),
        jtypes.SSDConfig(**ssd), jtypes.EngineConfig(
            **ECFG, cache=jtypes.CacheConfig(**cache)), 2, 16, 4)
    got = kv_tier.decode_tokens_per_s(
        configs.get_config("yi-34b", smoke=True), kv_tier.KVTierConfig(**TIER),
        types.SSDConfig(**ssd), types.EngineConfig(
            **ECFG, cache=types.CacheConfig(**cache)), 2, 16, 4,
        device="cpu")
    check_stats(want, got)


def test_serve_with_kv_tier_matches_reference():
    jcfg = jconfigs.get_config("yi-34b", smoke=True)
    tcfg = configs.get_config("yi-34b", smoke=True)
    tree = jtr.init_model(jax.random.PRNGKey(0), jcfg)
    params = convert.model_params_from_numpy(jax.tree.map(np.asarray, tree),
                                             tcfg, "cpu")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 16)).astype(
        np.int32)
    scfg_j = jloop.ServeConfig(batch=2, prompt_len=16, gen_tokens=4,
                               tier=jtier.KVTierConfig(**TIER))
    scfg_t = loop.ServeConfig(batch=2, prompt_len=16, gen_tokens=4,
                              tier=kv_tier.KVTierConfig(**TIER))
    want = jloop.serve_with_kv_tier(jcfg, tree, jnp.asarray(toks), scfg_j,
                                    jtypes.SSDConfig(**FAST),
                                    jtypes.EngineConfig(**ECFG))
    got = loop.serve_with_kv_tier(tcfg, params, t(toks), scfg_t,
                                  types.SSDConfig(**FAST),
                                  types.EngineConfig(**ECFG))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    check_stats(want, got)
    assert got["prefill_s"] >= 0.0 and got["wall_s"] >= 0.0


# The reference's decode_tokens_per_s at the serve command's full-width
# starcoder2-3b settings (KVTierConfig(hot_window=16, page_tokens=8),
# 40-MIOPS drive of 1000 instances and 2^14 blocks, EngineConfig(
# num_units=4, fetch_width=64), batch 4, prompt 32, 16 steps), run on the
# CPU. Virtual time: numbers of the emulated drive, not of any chip.
FULL_WIDTH_TIER = {
    "tokens_per_s": 2094.0494563255083,
    "avg_step_us": 1910.174560546875,
    "blocks_per_step": 5040.0,
    "iops_demand": 2638502.3149701403,
    "data_check_max_abs": 0.0,
    "hot_pages": 2,
}


def test_full_width_tier_reproduces_reference_numbers():
    """The serve command's starcoder2-3b tier at full width (23040 ops a
    step, 12 fetch passes), with the fused_reap path on and off."""
    cfg, _, _, ssd, scfg = serve_setup_without_model()
    runs = [kv_tier.decode_tokens_per_s(
        cfg, scfg.tier, ssd,
        types.EngineConfig(num_units=4, fetch_width=64, use_pallas_reap=reap),
        4, 32, 16, device="cpu") for reap in (False, True)]
    for got in runs:
        for key, want in FULL_WIDTH_TIER.items():
            assert got[key] == pytest.approx(want, rel=1e-6, abs=0), key
    assert runs[0] == runs[1]


# The reference's decode_tokens_per_s at the serve command's settings for
# two more architectures (KVTierConfig(hot_window=16, page_tokens=8), a
# 2.5e6-IOPS drive of 64 instances and 2^14 blocks, EngineConfig(
# num_units=4, fetch_width=64), 16 steps): recurrentgemma-9b at the
# defaults (batch 4, prompt 32; the tier counts its recurrent layers too,
# as the reference's does) and qwen2-moe-a2.7b at --batch 1 --prompt 24,
# run on the CPU. Virtual time.
ARCH_TIER = {
    "recurrentgemma-9b": (4, 32, {
        "tokens_per_s": 948.0161500661425,
        "avg_step_us": 4219.33740234375,
        "blocks_per_step": 6384.0,
        "iops_demand": 1513033.7755055635,
        "data_check_max_abs": 0.0,
        "hot_pages": 2,
    }),
    "qwen2-moe-a2.7b": (1, 24, {
        "tokens_per_s": 238.38102040113193,
        "avg_step_us": 4194.96484375,
        "blocks_per_step": 4992.0,
        "iops_demand": 1189998.0538424505,
        "data_check_max_abs": 0.0,
        "hot_pages": 2,
    }),
}


@pytest.mark.parametrize("arch", ARCH_TIER)
def test_full_width_tier_of_other_archs_reproduces_reference(arch):
    """``launch.serve``'s tier for recurrentgemma-9b and qwen2-moe-a2.7b
    at full width on the CPU: the reference's numbers."""
    batch, prompt, want = ARCH_TIER[arch]
    _, _, _, ssd, scfg = serve.setup(arch, smoke=True, batch=batch,
                                     prompt=prompt, device="cpu")
    assert (ssd.t_max_iops, ssd.n_instances) == (2.5e6, 64)
    got = kv_tier.decode_tokens_per_s(
        configs.get_config(arch), scfg.tier, ssd,
        types.EngineConfig(num_units=4, fetch_width=64), batch, prompt, 16,
        device="cpu")
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-6, abs=0), key


def test_moe_tier_at_the_default_prompt_overflows_the_rings():
    """qwen2-moe-a2.7b at batch 1 and the default prompt 32 submits
    2 x 18432 ops a step (every read and write slot), over the 32768 of
    the rings: a ValueError, as in the reference (ROADMAP, ring limit)."""
    _, _, _, ssd, scfg = serve.setup("qwen2-moe-a2.7b", smoke=True, batch=1,
                                     device="cpu")
    with pytest.raises(ValueError, match="36864 requests exceeds ring"):
        kv_tier.decode_tokens_per_s(
            configs.get_config("qwen2-moe-a2.7b"), scfg.tier, ssd,
            types.EngineConfig(num_units=4, fetch_width=64), 1, 32, 16,
            device="cpu")


def serve_setup_without_model():
    """The objects ``launch/serve.py`` builds for --arch starcoder2-3b
    --iops 40e6, with the full-width model's config but no parameters."""
    cfg = configs.get_config("starcoder2-3b")
    _, _, _, ssd, scfg = serve.setup("starcoder2-3b", smoke=True, iops=40e6,
                                     device="cpu")
    assert (ssd.t_max_iops, ssd.n_instances, ssd.num_blocks) == (
        40e6, 1000, 1 << 14)
    return cfg, None, None, ssd, scfg


def test_serve_cli_runs_on_the_cpu(capsys):
    out = serve.main(["--arch", "starcoder2-3b", "--smoke", "--gen", "3",
                      "--batch", "2", "--prompt", "16", "--iops", "40e6",
                      "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    assert out["data_check_max_abs"] == 0.0
    assert "virtual tokens/s" in capsys.readouterr().out


def test_multi_drive_tier_is_not_ported():
    """The striped tier is ported now (``tests/test_torch_array_client.py``
    holds it against the reference); a stripe wider than the array
    raises."""
    cfg = configs.get_config("yi-34b", smoke=True)
    with pytest.raises(ValueError, match="stripe_width=3"):
        kv_tier.decode_tokens_per_s(
            cfg, kv_tier.KVTierConfig(num_devices=2, stripe_width=3, **TIER),
            types.SSDConfig(**SLOW), types.EngineConfig(**ECFG), 2, 16, 2,
            device="cpu")
