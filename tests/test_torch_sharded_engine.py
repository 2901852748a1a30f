"""Serve-time tensor parallelism in the port (``ServeConfig(mesh_shape=(1,
tp))``, ``sharding/rules.py``) against the port's unsharded engine and
the JAX mesh engine, on the CPU.

The JAX engine shards one process over a (data, model) mesh with
``shard_map``; the port runs one process a rank over a
``torch.distributed`` gloo group. The cases mirror
``tests/test_sharded_engine.py`` and the TP cases of
``tests/test_fleet_engine.py`` on the smoke stablelm-1.6b with a 4+1d
adapter made by the JAX package:

* mesh (1, 1) in this process (a one-rank group): paged and dense, with
  and without ``row_parallel``, token-identical to the unsharded engine
  (a size-1 collective is exact) and to JAX's own mesh-(1, 1) engine,
  ``shards == 1``;
* the validation errors: a bad ``mesh_shape`` or ``tp_axis``, no process
  group, a world size other than tp, grouped int8 scales with
  ``row_parallel``, and the data axis / disaggregation that still raise;
* groups of 2 and 4 ranks, spawned once each for the module
  (``tp_engine_cases.rank_main``): live / lora / merged runtimes, both
  cache modes, int8 KV and weights, a warm prefix pass, row-parallel
  (also over int8 weights), each token-identical to the unsharded engine
  on every rank; per-rank pools of KV / tp heads and per-shard stats that
  sum to the global ones; heads that do not divide tp raise naming
  ``num_heads``.

The spawned ranks get a join deadline of their own (``JOIN_S``): a hung
collective fails the test and the ranks are killed.
"""
import multiprocessing as mp
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.config.base import QuantConfig as JQuantConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import ServeConfig as JServeConfig
from repro import configs as jconfigs
from repro.core import tt as jtt
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving.adapter_runtime import AdapterRuntime as JRuntime

from repro_torch.config.base import KernelConfig, QuantConfig, ServeConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.serving import Engine

import tp_engine_cases as C

KEY = jax.random.PRNGKey(0)
WORLDS = (2, 4)
JOIN_S = 180.0
#: the unsharded case each TP case is held to (row-parallel is a TP mode)
REF = {"rp_paged": "live_paged", "rp_dense": "live_dense",
       "rp_int8": "int8"}


@pytest.fixture(scope="module")
def setup():
    """JAX-made weights (``random_tt(0.8)``, as the JAX sharded tests),
    the JAX setup and the port's (cfg, spec, tp)."""
    jcfg = jconfigs.get_smoke_config(C.ARCH)
    jspec = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES["decode_32k"], adapter_kind="metatt",
        adapter_variant="4+1d", num_tasks=3, adapter_rank=4))
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.8)}
    cfg, spec = C.model()
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jspec, jp, cfg, spec, tp


@pytest.fixture(scope="module")
def unsharded(setup):
    """The port's unsharded engine on every case's requests."""
    _, _, _, cfg, spec, tp = setup
    out = {}
    for name in C.CASES:
        if name in REF:
            continue
        out[name], eng = C.case(name, cfg, spec, tp)
        out[name + "_stats"] = C.stats(eng)
    return out


def _one_rank(tmp):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store1",
                            world_size=1, rank=0)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process for the test's length."""
    _one_rank(tmp_path)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def groups(setup, tmp_path_factory):
    """Spawn a gloo group of 2 and one of 4 ranks at once, each rank
    running every case (``tp_engine_cases.rank_main``); join them under
    one ``JOIN_S`` deadline, killing every rank if it passes. Returns
    {world: [rank 0's results, rank 1's, ...]}."""
    tmp = tmp_path_factory.mktemp("tp")
    weights = str(tmp / "weights.pt")
    torch.save(setup[5], weights)
    ctx = mp.get_context("spawn")
    procs = {}
    for world in WORLDS:
        out = tmp / f"w{world}"
        out.mkdir()
        procs[world] = [ctx.Process(
            target=C.rank_main,
            args=(r, world, str(tmp / f"store{world}"), weights, str(out)))
            for r in range(world)]
    for ps in procs.values():
        for p in ps:
            p.start()
    deadline = time.monotonic() + JOIN_S
    every = [p for ps in procs.values() for p in ps]
    for p in every:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in every if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        pytest.fail(f"{len(hung)} spawned ranks still ran after {JOIN_S} s "
                    "(a hung collective?); killed")
    codes = [p.exitcode for p in every]
    assert codes == [0] * len(every), codes
    return {w: [torch.load(tmp / f"w{w}" / f"rank{r}.pt")
                for r in range(w)] for w in WORLDS}


# ---------------------------------------------------------------------------
# mesh (1, 1) in this process
# ---------------------------------------------------------------------------


def test_mesh_1x1_token_identical_to_unsharded(setup, unsharded, one_rank):
    """A one-rank group: paged and dense tokens equal to the unsharded
    engine's (the serve-TP context, the cache stripes and the size-1
    collectives are transparent), ``shards == 1``."""
    _, _, _, cfg, spec, tp = setup
    for name in ("live_paged", "live_dense"):
        got, eng = C.case(name, cfg, spec, tp, mesh=(1, 1))
        assert got == unsharded[name], name
        assert eng.last_stats.shards == 1
        assert eng.last_stats.kv_bytes_peak_per_shard == \
            eng.last_stats.kv_bytes_peak


@pytest.mark.parametrize("name", ["rp_paged", "rp_dense", "rp_int8"])
def test_mesh_1x1_row_parallel_exact(setup, unsharded, one_rank, name):
    """Row-parallel ``wo`` / ``wd`` / FFN with a size-1 all-reduce is
    bit-transparent: tokens equal to the unsharded engine's (over int8
    weights and KV too)."""
    _, _, _, cfg, spec, tp = setup
    got, _ = C.case(name, cfg, spec, tp, mesh=(1, 1))
    assert got == unsharded[REF[name]]


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_mesh_1x1_token_identical_to_jax_mesh_engine(setup, one_rank, mode):
    """The port's mesh-(1, 1) engine against the JAX engine on its own
    mesh (1, 1) (shard_map over one device), same weights and requests:
    tokens identical."""
    jcfg, jspec, jp, cfg, spec, tp = setup
    work = C.work(cfg.vocab_size)
    sv = dict(max_batch=2, cache_len=32, out_cap=8, page_size=8,
              prefill_chunk=4, mesh_shape=(1, 1), cache_mode=mode)
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    jeng = JEngine(jcfg, jrt, serve=JServeConfig(**sv))
    want = [np.asarray(o).tolist() for o in jeng.generate(
        [JRequest(p, n, task=t) for p, n, t in work])]
    got, eng = C.serve(cfg, C.runtime("live", cfg, spec, tp), work,
                       **{k: v for k, v in sv.items() if k != "mesh_shape"},
                       mesh=(1, 1))
    assert got == want
    assert eng.last_stats.shards == jeng.last_stats.shards == 1
    assert eng.last_stats.kv_bytes_peak == jeng.last_stats.kv_bytes_peak


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def test_mesh_validation_errors(setup, tmp_path):
    """Bad shapes and axes, a mesh with no process group or with a group
    of another size, grouped int8 scales with row_parallel (from
    ``ServeConfig`` and from the ``KernelConfig`` merge); a data axis
    above 1 and ``disagg`` are not ported."""
    _, _, _, cfg, spec, tp = setup
    rt = C.runtime("live", cfg, spec, tp)
    with pytest.raises(ValueError):     # not a (data, model) pair
        ServeConfig(mesh_shape=(2,)).validate()
    with pytest.raises(ValueError):     # unknown TP axis name
        ServeConfig(mesh_shape=(1, 1), tp_axis="pod").validate()
    with pytest.raises(ValueError, match="needs a mesh|set mesh_shape"):
        ServeConfig(row_parallel=True).validate()
    with pytest.raises(ValueError, match="group_size"):
        ServeConfig(mesh_shape=(1, 1), row_parallel=True,
                    quant=QuantConfig(weights="int8",
                                      group_size=64)).validate()
    for bad in (dict(mesh_shape=(2, 1)), dict(mesh_shape=(1, 2),
                                              tp_axis="data"),
                dict(disagg=True)):
        with pytest.raises(NotImplementedError):
            ServeConfig(**bad).validate()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="no process group"):
        Engine(cfg, rt, serve=ServeConfig(mesh_shape=(1, 1)), device="cpu")
    _one_rank(tmp_path)
    try:
        with pytest.raises(ValueError, match="has 1 ranks"):
            Engine(cfg, rt, serve=ServeConfig(mesh_shape=(1, 2)),
                   device="cpu")
        with pytest.raises(ValueError, match="group_size"):
            Engine(cfg, rt, serve=ServeConfig(mesh_shape=(1, 1),
                                              row_parallel=True),
                   kernels=KernelConfig(quant=QuantConfig(
                       weights="int8", group_size=64)), device="cpu")
        # the tp axis may be either mesh axis
        got, _ = C.serve(cfg, rt, C.work(cfg.vocab_size)[:2],
                         mesh=(1, 1), tp_axis="data")
        want, _ = C.serve(cfg, rt, C.work(cfg.vocab_size)[:2])
        assert got == want
    finally:
        dist.destroy_process_group()


def test_jax_mesh_config_checks_match():
    """The port's ServeConfig refuses what JAX's refuses among the TP
    fields (bad shape, bad axis, row_parallel without a mesh or with
    grouped scales)."""
    bad = [dict(mesh_shape=(2,)), dict(mesh_shape=(1, 1), tp_axis="pod"),
           dict(row_parallel=True),
           dict(mesh_shape=(1, 1), row_parallel=True,
                quant="grouped")]
    for kw in bad:
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("quant") == "grouped":
            jkw["quant"] = JQuantConfig(weights="int8", group_size=64)
            tkw["quant"] = QuantConfig(weights="int8", group_size=64)
        with pytest.raises(ValueError):
            JServeConfig(**jkw).validate()
        with pytest.raises(ValueError):
            ServeConfig(**tkw).validate()


# ---------------------------------------------------------------------------
# spawned gloo groups of 2 and 4 ranks
# ---------------------------------------------------------------------------


def _ranks_agree(res, key):
    first = res[0][key]
    for r in res[1:]:
        assert r[key] == first
    return first


@pytest.mark.parametrize("world", WORLDS)
def test_tp_token_parity_all_runtimes(groups, unsharded, world):
    """live / lora / merged paged engines under TP: every rank's tokens
    equal the unsharded engine's."""
    toks = _ranks_agree(groups[world], "tokens")
    for name in ("live_paged", "lora_paged", "merged_paged"):
        assert toks[name] == unsharded[name], name
    assert groups[world][0]["stats"]["live_paged"]["shards"] == world


@pytest.mark.parametrize("mode", ["paged", "dense"])
@pytest.mark.parametrize("world", WORLDS)
def test_tp_token_parity_both_cache_modes(groups, unsharded, world, mode):
    toks = _ranks_agree(groups[world], "tokens")
    assert toks[f"live_{mode}"] == unsharded[f"live_{mode}"]


@pytest.mark.parametrize("world", WORLDS)
def test_tp_int8_kv_and_weights_parity(groups, unsharded, world):
    """w8a16 + int8 paged KV under TP: tokens equal the unsharded int8
    engine's, and each rank's int8 cells and scale pools hold KV / tp
    heads."""
    toks = _ranks_agree(groups[world], "tokens")
    assert toks["int8"] == unsharded["int8"]
    kv = C.model()[0].num_kv_heads
    for res in groups[world]:
        shapes = res["pools"]["int8"]
        assert len(shapes) == 4        # k, v, k_s, v_s of one position
        assert all(s[3] == kv // world for s in shapes), shapes


@pytest.mark.parametrize("world", WORLDS)
def test_tp_warm_prefix_cache_token_identical(groups, world):
    """A warm second pass under TP reproduces the cold tokens, hits the
    prefix cache and copies on write; no block leaks."""
    toks = _ranks_agree(groups[world], "tokens")
    assert toks["warm"] == toks["live_paged"]
    st = groups[world][0]["stats"]
    assert st["live_paged"]["prefix_hit_rate"] == 0.0
    assert st["warm"]["prefix_hit_rate"] > 0
    assert st["warm"]["cow_copies"] > 0
    assert all(r["leaked"] == 0 for r in groups[world])


@pytest.mark.parametrize("world", WORLDS)
def test_tp_stats_per_shard_sums_to_global(groups, unsharded, world):
    """Global byte figures equal the unsharded engine's; the per-shard
    ones are global / tp and sum back to them; each rank's pool leaves
    hold KV / tp heads (axis 3) and every other dim whole."""
    one = unsharded["live_paged_stats"]
    kv = C.model()[0].num_kv_heads
    for res in groups[world]:
        st = res["stats"]["live_paged"]
        assert st["shards"] == world and one["shards"] == 1
        assert st["block_bytes"] == one["block_bytes"]
        assert st["kv_bytes_peak"] == one["kv_bytes_peak"]
        assert st["block_bytes_per_shard"] * world == st["block_bytes"]
        assert st["kv_bytes_peak_per_shard"] * world == st["kv_bytes_peak"]
        for shape in res["pools"]["live_paged"]:
            assert shape[3] == kv // world, shape
    _ranks_agree(groups[world], "pools")


@pytest.mark.parametrize("world", WORLDS)
def test_tp_row_parallel_matches_column_oracle(groups, world):
    """Row-parallel ``wo`` / ``wd`` / FFN with the all-reduce epilogue
    against the column-only oracle (f32 smoke config, as JAX asserts it:
    token identity), in both cache modes and over int8 weights."""
    toks = _ranks_agree(groups[world], "tokens")
    for rp, col in REF.items():
        assert toks[rp] == toks[col], rp


@pytest.mark.parametrize("world", WORLDS)
def test_tp_rejects_indivisible_heads(groups, world):
    """Heads that do not divide tp fail loudly, naming ``num_heads``: a
    replicated fallback would void the per-rank KV bytes."""
    for res in groups[world]:
        assert res["indivisible"] is not None
        assert "num_heads" in res["indivisible"]
