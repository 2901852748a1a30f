"""The serve-TP cases of ``tests/test_torch_sharded_engine.py``: the
requests, the engines, and the body each rank of a spawned gloo group
runs (``rank_main``). Imports torch and the port only, so that a spawned
rank starts without JAX.

Every rank loads the same weights (made by the JAX package, saved by the
test with ``torch.save``), builds the same engines with the same seed and
serves the same requests under ``ServeConfig(mesh_shape=(1, tp))``; each
rank writes what it saw (tokens, stats, its pool shapes) to
``<out>/rank<r>.pt``.
"""
import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.config.base import QuantConfig, RunConfig, ServeConfig
from repro_torch.models import model as TM
from repro_torch.serving import AdapterRuntime, Engine, Request

ARCH = "stablelm-1.6b"
Q8 = QuantConfig(weights="int8", kv="int8")
#: name -> (runtime mode, ServeConfig fields, only the requests of task 1)
CASES = {
    "live_paged": ("live", {}, False),
    "lora_paged": ("lora", {}, False),
    "merged_paged": ("merged", {}, True),
    "live_dense": ("live", dict(cache_mode="dense"), False),
    "int8": ("lora", dict(quant=Q8), False),
    "rp_paged": ("live", dict(row_parallel=True), False),
    "rp_dense": ("live", dict(cache_mode="dense", row_parallel=True), False),
    "rp_int8": ("lora", dict(quant=Q8, row_parallel=True), False),
}


def model():
    """The smoke stablelm config and its 4+1d MetaTT spec over 3 tasks
    at rank 4 (the JAX sharded-engine tests' setup)."""
    cfg = configs.get_smoke_config(ARCH)
    spec = TM.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant="4+1d",
        num_tasks=3, adapter_rank=4))
    return cfg, spec


def work(vocab, n=5, tasks=3):
    """``n`` mixed-task, mixed-length requests [(prompt, max_new, task)]."""
    return [(np.random.default_rng(100 + i).integers(0, vocab, 4 + i),
             5 + (i % 3), i % tasks) for i in range(n)]


def runtime(mode, cfg, spec, tp):
    kw = dict(model_cfg=cfg, task=1) if mode == "merged" else {}
    return AdapterRuntime.build(mode, tp["base"], spec, tp["adapter"],
                                tp["frozen"], **kw)


def serve(cfg, rt, reqs, *, mesh=(), **kw):
    """Fresh engine on the CPU, one ``generate``: (tokens, engine)."""
    sv = dict(max_batch=2, cache_len=32, out_cap=8, page_size=8,
              prefill_chunk=4, mesh_shape=mesh)
    sv.update(kw)
    eng = Engine(cfg, rt, serve=ServeConfig(**sv), device="cpu")
    return [o.tolist() for o in eng.generate(
        [Request(p, n, task=t) for p, n, t in reqs])], eng


def case(name, cfg, spec, tp, mesh=()):
    """Tokens of case ``name`` and its engine."""
    mode, kw, task1 = CASES[name]
    reqs = work(cfg.vocab_size)
    if task1:
        reqs = [r for r in reqs if r[2] == 1]
    return serve(cfg, runtime(mode, cfg, spec, tp), reqs, mesh=mesh, **kw)


def pool_shapes(eng):
    return [tuple(leaf.shape) for c in eng._paged_caches
            for leaf in c["self"].values()]


def stats(eng):
    st = eng.last_stats
    return dict(shards=st.shards, block_bytes=st.block_bytes,
                kv_bytes_peak=st.kv_bytes_peak,
                block_bytes_per_shard=st.block_bytes_per_shard,
                kv_bytes_peak_per_shard=st.kv_bytes_peak_per_shard,
                prefix_hit_rate=st.prefix_hit_rate,
                cow_copies=st.cow_copies)


def run_cases(weights: str, world: int) -> dict:
    """Every case on this rank's engines under ``mesh_shape=(1, world)``."""
    cfg, spec = model()
    tp = torch.load(weights)
    mesh = (1, world)
    out = {"tokens": {}, "stats": {}, "pools": {}}
    for name in CASES:
        toks, eng = case(name, cfg, spec, tp, mesh)
        out["tokens"][name] = toks
        out["stats"][name] = stats(eng)
        if eng.paged:
            out["pools"][name] = pool_shapes(eng)
        if name == "live_paged":      # the same requests again, warm
            out["tokens"]["warm"] = [o.tolist() for o in eng.generate(
                [Request(p, n, task=t) for p, n, t in work(cfg.vocab_size)])]
            out["stats"]["warm"] = stats(eng)
            out["leaked"] = eng.leaked_blocks()
    bad = dataclasses.replace(cfg, num_heads=world + 1,
                              num_kv_heads=world + 1)
    try:
        Engine(bad, runtime("live", cfg, spec, tp),
               serve=ServeConfig(mesh_shape=mesh, cache_len=32, out_cap=8),
               device="cpu")
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def rank_main(rank: int, world: int, store: str, weights: str,
              out: str) -> None:
    """One rank of a spawned gloo group over the ``file://`` store
    ``store``: run every case and save what this rank saw."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(run_cases(weights, world), f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
