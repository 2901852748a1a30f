"""The port's quantized serving path (int8 base weights, int8 paged KV)
against the JAX package's, model and engine.

Weights are made by the JAX package (its PRNG, as tests/test_quant.py
makes them: smoke stablelm-1.6b, MetaTT 4d or 4+1d) and carried across
with ``convert.from_jax_numpy``; each package quantizes the same fp base
with its own ``quantize_base`` (bit-identical, tests/test_torch_quant.py).
All in f32 on the CPU, where the port's kernel wrappers run their plain
versions.

* The forward over a quantized base: logits within 5e-5 of the JAX
  forward (the JAX package's own tolerance for this comparison).
* One int8 ``paged_step``: logits within 1e-5 of the largest JAX logit;
  scale pools within 1e-5 of each JAX scale (the k/v they quantize come
  out of f32 sums taken in another order); int8 cells equal, except cells
  whose f32 value sits on a rounding boundary of the quantization grid,
  which may differ by one quantum (the test counts them).
* A step whose every write is a sentinel leaves every pool bit-identical.
* Greedy tokens of the port's int8 paged engine (four QuantConfigs) and
  w8 dense engine IDENTICAL to the JAX engines' (the ``live`` runtime,
  and the ``lora`` runtime tests/test_quant.py serves), with equal dtype
  and KV-memory stats; warm == cold with prefix hits and copy-on-write.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import KernelConfig as JKernelConfig
from repro.config.base import QuantConfig as JQuantConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import ServeConfig as JServeConfig
from repro.core import tt as jtt
from repro.kernels import dispatch as jdispatch
from repro.kernels import quant as jquant
from repro.models import model as JM
from repro.models import transformer as JT
from repro.peft import api as jpeft
from repro.serving import AdapterRuntime as JRuntime
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch import configs as tconfigs
from repro_torch.config.base import (KernelConfig, QuantConfig, RunConfig,
                                     ServeConfig)
from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import quant as tquant
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.peft import api as tpeft
from repro_torch.serving import AdapterRuntime, Engine, Request

KEY = jax.random.PRNGKey(0)
ARCH = "stablelm-1.6b"
JPALLAS = jdispatch.resolve(JKernelConfig(backend="pallas", interpret=True))
#: tests/test_quant.py's engine geometry
SERVE = dict(max_batch=2, cache_len=32, out_cap=8, page_size=8,
             prefill_chunk=4)
QCONFIGS = [dict(kv="int8"), dict(weights="int8"),
            dict(weights="int8", kv="int8"),
            dict(weights="int8", kv="int8", group_size=128)]
STATS = ("weights_dtype", "kv_dtype", "num_blocks", "block_bytes",
         "kv_blocks_peak", "kv_bytes_peak", "prefix_hit_tokens",
         "cow_copies", "tokens_generated")


@functools.lru_cache(maxsize=None)
def _setup(variant="4+1d", num_tasks=2, scale=0.8, shape="decode_32k"):
    """JAX params as tests/test_quant.py builds them, and the same weights
    as the port's tensors."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    jspec = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES[shape], adapter_kind="metatt",
        adapter_variant=variant, num_tasks=num_tasks, adapter_rank=4))
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=scale)}
    cfg = tconfigs.get_smoke_config(ARCH)
    spec = TM.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant=variant,
        num_tasks=num_tasks, adapter_rank=4))
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jspec, jp, cfg, spec, tp


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,num_tasks", [("4d", 0), ("4+1d", 2)])
@pytest.mark.parametrize("group", [0, 128])
def test_forward_over_quantized_base_matches_jax(variant, num_tasks, group):
    """tests/test_quant.py's forward parity, port against JAX: the adapted
    q/v run #9's plain version, the other projections dequantize."""
    jcfg, jspec, jp, cfg, spec, tp = _setup(variant, num_tasks, 0.5,
                                            "train_4k")
    jq = jquant.quantize_base(jp["base"], group_size=group)
    tq = tquant.quantize_base(tp["base"], group_size=group)
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    tokens = np.array(jax.random.randint(KEY, (2, 9), 0, jcfg.vocab_size))
    task = 1 if variant == "4+1d" else None
    with torch.inference_mode():
        got = {name: TT.forward(tq, cfg, spec, bc, pl, tokens, task=task,
                                policy=pol, device="cpu").logits
               for name, pol in (("kernel", None), ("ref", tdispatch.REF))}
    for jpol in (None, JPALLAS):
        want = JT.forward(jq, jcfg, jspec, jbc, jpl, jnp.asarray(tokens),
                          task=None if task is None else jnp.int32(task),
                          policy=jpol).logits
        for g in got.values():
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       atol=5e-5, rtol=5e-5)


N, PAGE, P_TAB = 10, 8, 5


def _int8_pools(jcfg, cfg, seed):
    """int8 pools holding stale quantized cells of earlier requests, as a
    JAX pytree and as the port's tensors (the same bits)."""
    rng = np.random.default_rng(seed)
    jc = JT.init_paged_caches(jcfg, N, PAGE, jnp.float32, kv_quant=True)
    jc = jax.tree_util.tree_map(
        lambda a: jnp.asarray(
            rng.integers(-127, 128, a.shape) if a.dtype == jnp.int8
            else rng.uniform(0.001, 0.05, a.shape), a.dtype), jc)
    tc = from_jax_numpy(jax.device_get(jc), device="cpu")
    fresh = TT.init_paged_caches(cfg, N, PAGE, torch.float32, kv_quant=True,
                                 device="cpu")
    for f, t in zip(fresh, tc):        # same leaves, dtypes and shapes
        assert {k: (v.dtype, v.shape) for k, v in f["self"].items()} == \
            {k: (v.dtype, v.shape) for k, v in t["self"].items()}
    return jc, tc


def _leaves(caches):
    return [c["self"][k] for c in caches for k in ("k", "v", "k_s", "v_s")]


def _mixed_step():
    """Slot 0 decodes at position 13, slot 1 prefills 4 prompt tokens from
    5, slot 2 prefills 2 from 6 (its pad columns run into a sentinel
    page), slot 3 is idle (all-sentinel row)."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 128, (4, 4))
    tables = np.full((4, P_TAB), N, np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[1, :2] = [0, 5]
    tables[2, :1] = [8]
    pos = np.array([13, 5, 6, 0], np.int32)
    sel = np.array([0, 3, 1, 0], np.int32)
    task = np.array([1, 0, 1, 0], np.int32)
    return toks, tables, pos, sel, task


def _step(toks, tables, pos, sel, task, jpolicy, tpolicy, seed=0,
          record=None):
    jcfg, jspec, jp, cfg, spec, tp = _setup()
    jbase = jquant.quantize_base(jp["base"])
    tbase = tquant.quantize_base(tp["base"])
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], {})
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], {})
    jc, tc = _int8_pools(jcfg, cfg, seed)
    before = [t.clone() for t in _leaves(tc)]
    want, jnew = JT.paged_step(
        jbase, jcfg, jspec, jbc, jpl, jnp.asarray(toks), jc,
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(sel),
        task=jnp.asarray(task), policy=jpolicy)
    with torch.inference_mode():
        got, tnew = TT.paged_step(
            tbase, cfg, spec, bc, pl, toks, tc, torch.from_numpy(tables),
            torch.from_numpy(pos), torch.from_numpy(sel),
            task=torch.from_numpy(task), policy=tpolicy, device="cpu")
    assert tnew is tc                   # the pools are written in place
    return got, want, before, _leaves(tc), _leaves(jnew)


@pytest.mark.parametrize("jpolicy,tpolicy", [
    (None, None), (JPALLAS, None), (None, tdispatch.REF)],
    ids=["jax_ref", "jax_pallas_interpret", "port_ref"])
def test_int8_paged_step_matches_jax(jpolicy, tpolicy, monkeypatch):
    toks, tables, pos, sel, task = _mixed_step()
    # record the f32 k / v each layer quantizes (in write-plan row order)
    seen = []
    quantize_kv = tquant.quantize_kv

    def recording(x):
        seen.append(x.clone())
        return quantize_kv(x)
    monkeypatch.setattr(tattn.quant_lib, "quantize_kv", recording)
    got, want, before, tpools, jpools = _step(toks, tables, pos, sel, task,
                                              jpolicy, tpolicy)
    assert got.shape == want.shape and _rel(got, want) < 1e-5
    rows, blk, off = tattn.paged_write_plan(
        torch.from_numpy(tables), torch.from_numpy(pos)[:, None]
        + torch.arange(4)[None], N, PAGE)
    # scale pools: close; int8 pools: equal, or one quantum apart where the
    # f32 value quantized (x / scale, recorded per layer) lies on a
    # half-quantum boundary
    tk, tv, tks, tvs = tpools
    jk, jv, jks, jvs = (torch.from_numpy(np.array(j)) for j in jpools)
    torch.testing.assert_close(tks, jks, rtol=1e-5, atol=0)
    torch.testing.assert_close(tvs, jvs, rtol=1e-5, atol=0)
    boundary = 0
    for which, (t, j, scale) in enumerate(((tk, jk, tks), (tv, jv, tvs))):
        diff = (t.int() - j.int()).abs()
        assert int(diff.max()) <= 1
        for sb in range(t.shape[0]):
            x = seen[2 * sb + which]                     # (rows, KV, hd)
            frac = (x / scale[sb][blk, off][..., None]).abs() % 1.0
            moved = diff[sb][blk, off] > 0
            assert bool(((frac[moved] - 0.5).abs() < 1e-3).all())
            boundary += int(moved.sum())
        # no cell outside the write plan moved
        assert int(diff.sum()) == sum(
            int((diff[sb][blk, off] > 0).sum()) for sb in range(t.shape[0]))
    assert len(seen) == 2 * tk.shape[0]
    # cells that sit on a boundary at this step and seed: none, so the
    # int8 pools are equal cell for cell
    assert boundary == 0
    # block 2 (free) and cells past slot 2's page are never written
    for t, b in zip(tpools, before):
        for blk_ in (2, 4, 6, 9):
            assert torch.equal(t[:, blk_], b[:, blk_])


def test_sentinel_only_writes_leave_every_pool_bit_identical():
    toks, _, _, sel, task = _mixed_step()
    tables = np.full((4, P_TAB), N, np.int32)
    tables[1, :] = [0, 5, 2, 4, 6]          # slot 1 sits past its table
    pos = np.array([0, P_TAB * PAGE, 17, 3], np.int32)
    _, _, before, tpools, jpools = _step(toks, tables, pos, sel, task, None,
                                         None, seed=1)
    for t, b, j in zip(tpools, before, jpools):
        assert torch.equal(t, b)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_copy_cache_block_carries_the_scale_pools():
    jcfg, _, _, cfg, _, _ = _setup()
    jc, tc = _int8_pools(jcfg, cfg, 2)
    jc = JT.copy_cache_block(jc, 3, 7)
    TT.copy_cache_block(tc, 3, 7)
    jc = JT.copy_cache_block(jc, 1, N)          # sentinel dst: dropped
    TT.copy_cache_block(tc, 1, N)
    for t, j in zip(_leaves(tc), _leaves(jc)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert torch.equal(t[:, 7], t[:, 3])


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _workload():
    """tests/test_quant.py's ``_engine_setup`` requests."""
    cfg = jconfigs.get_smoke_config(ARCH)
    return [(np.asarray(jax.random.randint(jax.random.PRNGKey(i), (4 + i,),
                                           0, cfg.vocab_size)), 6, i % 2)
            for i in range(5)]


def _engines(qc: dict, mode="live", **kw):
    jcfg, jspec, jp, cfg, spec, tp = _setup()
    jrt = JRuntime.build(mode, jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    trt = AdapterRuntime.build(mode, tp["base"], spec, tp["adapter"],
                               tp["frozen"])
    jk = kw.pop("jkernels", None)
    sv = dict(SERVE, **kw)
    return (JEngine(jcfg, jrt, serve=JServeConfig(quant=JQuantConfig(**qc),
                                                  **sv), kernels=jk),
            Engine(cfg, trt, serve=ServeConfig(quant=QuantConfig(**qc), **sv),
                   device="cpu"))


def _serve(jeng, teng, work):
    want = [o.tolist() for o in jeng.generate(
        [JRequest(p, n, task=t) for p, n, t in work])]
    got = [o.tolist() for o in teng.generate(
        [Request(p, n, task=t) for p, n, t in work])]
    assert got == want
    for name in STATS:
        assert getattr(teng.last_stats, name) == \
            getattr(jeng.last_stats, name), name
    return got


@functools.lru_cache(maxsize=None)
def _fp_paged_stats():
    _, teng = _engines({})
    teng.generate([Request(p, n, task=t) for p, n, t in _workload()])
    return teng.last_stats


@pytest.mark.parametrize("qc", QCONFIGS, ids=lambda q: "-".join(
    f"{k}={v}" for k, v in q.items()))
def test_int8_paged_engine_token_identical_to_jax(qc):
    jeng, teng = _engines(qc)
    _serve(jeng, teng, _workload())
    st, fp = teng.last_stats, _fp_paged_stats()
    assert st.weights_dtype == qc.get("weights", "fp").replace("none", "fp")
    assert st.kv_dtype == qc.get("kv", "fp")
    if qc.get("kv") == "int8":
        assert st.num_blocks == fp.num_blocks
        assert st.block_bytes < fp.block_bytes
        assert st.kv_bytes_peak < fp.kv_bytes_peak
    assert teng.leaked_blocks() == 0
    if qc.get("weights") == "int8":
        assert tquant.is_quantized(teng.base_weights["blocks"][0]["mixer"]
                                   ["wq"])


@pytest.mark.parametrize("cache", ["paged", "dense"])
def test_int8_engines_lora_runtime_token_identical_to_jax(cache):
    """tests/test_quant.py's runtime: the pre-folded lora factors
    (A = α·G1·C) over the int8 base — paged with int8 KV, and dense with
    int8 weights (#9 / #10's plain versions)."""
    if cache == "paged":
        jeng, teng = _engines(dict(weights="int8", kv="int8"), mode="lora")
    else:
        jeng, teng = _engines(dict(weights="int8"), mode="lora",
                              cache_mode="dense")
    assert teng.rt.mode == "lora" and set(teng.rt.per_layer) == {"a"}
    _serve(jeng, teng, _workload())
    if cache == "paged":
        assert teng.leaked_blocks() == 0


def test_int8_paged_engine_matches_jax_pallas_interpret_leg():
    jeng, teng = _engines(dict(weights="int8", kv="int8"),
                          jkernels=JKernelConfig(backend="pallas",
                                                 interpret=True))
    _serve(jeng, teng, _workload())


def test_int8_engine_warm_prefix_cache_equals_cold():
    """Prefix cache and copy-on-write carry the int8 cells and their
    scales: a warm rerun reuses them and gives the cold run's tokens, as
    the JAX engine's warm run does."""
    jeng, teng = _engines(dict(weights="int8", kv="int8"))
    cold = _serve(jeng, teng, _workload())
    warm = _serve(jeng, teng, _workload())
    assert warm == cold
    st = teng.last_stats
    assert st.prefix_hit_rate > 0 and st.cow_copies > 0
    assert teng.leaked_blocks() == 0


def test_int8_kv_requires_paged_mode_and_weights_merge_from_kernels():
    _, _, _, cfg, spec, tp = _setup()
    trt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                               tp["frozen"])
    dense = dict(max_batch=2, cache_len=32, out_cap=8, cache_mode="dense")
    with pytest.raises(ValueError):
        Engine(cfg, trt, serve=ServeConfig(quant=QuantConfig(kv="int8"),
                                           **dense), device="cpu")
    with pytest.raises(ValueError):
        Engine(cfg, trt, serve=ServeConfig(**dense), device="cpu",
               kernels=KernelConfig(quant=QuantConfig(kv="int8")))
    # weights quantized through KernelConfig.quant: fine in dense mode
    eng = Engine(cfg, trt, serve=ServeConfig(**dense), device="cpu",
                 kernels=KernelConfig(quant=QuantConfig(weights="int8",
                                                        group_size=128)))
    assert eng.quant == QuantConfig(weights="int8", group_size=128)
    assert tquant.is_quantized(eng.base_weights["blocks"][0]["mixer"]["wq"])
    assert not tquant.is_quantized(trt.base["blocks"][0]["mixer"]["wq"])


@pytest.mark.parametrize("group", [0, 128])
def test_w8_dense_engine_token_identical_to_jax(group):
    """Dense mode, weights int8 through KernelConfig.quant: prefill runs
    #9's plain version (scalar task, 2-D A), decode #10's ((B,) task)."""
    jcfg, jspec, jp, cfg, spec, tp = _setup()
    qc = dict(weights="int8", group_size=group)
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    trt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                               tp["frozen"])
    dense = dict(max_batch=2, cache_len=32, out_cap=8, cache_mode="dense")
    jeng = JEngine(jcfg, jrt, serve=JServeConfig(**dense),
                   kernels=JKernelConfig(quant=JQuantConfig(**qc)))
    teng = Engine(cfg, trt, serve=ServeConfig(**dense), device="cpu",
                  kernels=KernelConfig(quant=QuantConfig(**qc)))
    _serve(jeng, teng, _workload())
    assert teng.last_stats.weights_dtype == "int8"
    assert teng.last_stats.kv_dtype == "fp"
