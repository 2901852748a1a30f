"""The MoE model family and MetaTT-(4+E)D in the port against the JAX
package (f32, on the CPU).

granite-moe-1b-a400m (32 experts of d_ff 512, top-8, capacity factor
2.0) and kimi-k2 (384 experts, top-8, one shared expert, capacity factor
1.25) run the capacity-dispatched expert FFN of ``models/moe.py``; on the
card granite-moe is served and trained at full width (``chip_smoke.py``
phase 16). Here, on each smoke config (granite: 4 experts, top-2, where
the capacity never binds; kimi: 8 experts, top-2, a shared expert, where
it does), with weights made by the JAX package (its PRNG) and carried
across with ``repro_torch.convert.from_jax_numpy``:

* both configs equal the JAX ones field for field; the full-width
  granite-moe has 1,334,756,352 base parameters in both packages (counted
  on the meta device / through ``jax.eval_shape``);
* ``moe_ffn`` within 1e-5 (f32, relative to the largest value) of the
  JAX one, with and without shared experts, at capacity factors 2.0,
  1.25 and 0.5 (0.5 drops pairs, and the test asserts that some are
  dropped), with the 4+ed expert delta, and its aux losses;
* exact router ties (duplicated router columns): the top-k and the
  dispatch equal ``jax.lax.top_k`` / ``jnp.argsort`` pair for pair;
* the forward (logits, caches, aux), one decode step and one paged step
  within 1e-5 for MetaTT 4d, 4+1d and 4+ed under the JAX reference path,
  and for 4+1d and 4+ed under its Pallas kernels in interpret mode;
  token-by-token decode equals the parallel forward on granite-moe (the
  case of
  ``tests/test_serving.py::test_decode_matches_parallel_forward``).

The engines are held to the JAX engines in
``tests/test_torch_moe_engines.py``, training in
``tests/test_torch_moe_train.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.core import tt as jtt
from repro.kernels import dispatch as jdispatch
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.models.layers import AdapterCtx as JCtx
from repro.peft import api as jpeft

from repro_torch import configs as tconfigs
from repro_torch.config.base import RunConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.models.layers import AdapterCtx
from repro_torch.peft import api as tpeft

GRANITE, KIMI = "granite-moe-1b-a400m", "kimi-k2-1t-a32b"
ARCHS = [GRANITE, KIMI]
KEY = jax.random.PRNGKey(29)
TOL = 1e-5
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
POLICIES = {"ref": None, "pallas_interpret": jdispatch.PALLAS_INTERPRET}
VARIANTS = ("4d", "4+1d", "4+ed")
CASES = [(a, v) for a in ARCHS for v in VARIANTS]
#: (arch, variant, JAX policy): every case under the reference path; the
#: Pallas kernels in interpret mode on the task- and expert-axis variants
#: (4d's kernels are 4+1d's with a scalar task)
POLICY_CASES = ([(a, v, "ref") for a, v in CASES]
                + [(a, v, "pallas_interpret") for a, v in CASES
                   if v != "4d"])
#: the full-width base parameters of granite-moe-1b (JAX init_base_params)
GRANITE_PARAMS = 1_334_756_352
#: the served adapter's ``random_tt`` scale
SCALE = 0.3
#: the aux weight the smoke models are built with here (0 in the configs:
#: no aux terms at all), so that forward and loss carry them
AUX = 0.01


def _rel(got, want) -> float:
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _runs(cfg, jcfg, variant, rank=4):
    common = dict(adapter_kind="metatt", adapter_variant=variant,
                  adapter_rank=rank)
    if variant == "4+1d":
        common["num_tasks"] = 3
    return (JRunConfig(model=jcfg, shape=SHAPES["decode_32k"], **common),
            RunConfig(model=cfg, **common))


def _configs(arch, **over):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **over),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **over))


@functools.lru_cache(maxsize=None)
def _base(arch, aux):
    """The base ``JM.init_params(jcfg, spec, KEY)`` draws for ``arch``'s
    smoke config (from the first half of KEY's split, whatever the
    adapter), made once for every variant, and its torch copy."""
    jcfg, _ = _configs(arch, moe_aux_weight=aux)
    jb = JT.init_base_params(jcfg, jax.random.split(KEY)[0])
    return jb, from_jax_numpy(jax.device_get(jb), device="cpu")


@functools.lru_cache(maxsize=None)
def setup(arch, variant, aux=AUX):
    """``arch``'s smoke config (aux weight ``aux``) in both packages with
    a MetaTT adapter of ``variant`` at rank 4 (4+1d: q/v over 3 tasks;
    4+ed: q/v and ``moe_down``), ``random_tt(scale=SCALE)``, made by the
    JAX package as ``JM.init_params`` makes them (the base shared between
    variants: ``_base``). Returns (jcfg, jspec, jp, cfg, spec, tp)."""
    jcfg, cfg = _configs(arch, moe_aux_weight=aux)
    jrun, trun = _runs(cfg, jcfg, variant)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jbase, tbase = _base(arch, aux)
    _, frozen = jpeft.init_adapter(jspec, jax.random.split(KEY)[1])
    jp = {"adapter": {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                             scale=SCALE)},
          "frozen": frozen}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    jp["base"], tp["base"] = jbase, tbase
    return jcfg, jspec, jp, cfg, spec, tp


def _task(variant, n=None):
    """A task index for ``variant``: None (4d), 1 or a (n,) vector."""
    if variant == "4d":
        return None
    if n is None:
        return 1
    return np.arange(n) % 3 if variant == "4+1d" else None


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_field_by_field(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    cfg, jcfg = getattr(tconfigs, get)(arch), getattr(jconfigs, get)(arch)
    assert arch in tconfigs.ALL_IDS
    for f in dataclasses.fields(jcfg):
        want = getattr(jcfg, f.name)
        assert getattr(cfg, f.name) == DTYPES.get(want, want), f.name
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.block_pattern == (("attn", "moe"),)
    TT.check_supported(cfg)
    run = RunConfig(model=cfg, adapter_variant="4+ed")
    spec = TM.build_adapter_spec(run)
    jspec = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES["train_4k"], adapter_variant="4+ed"))
    assert spec.cfg.matrix_types == ("attn_q", "attn_v", "moe_down")
    assert spec.cfg.mode_sizes == jspec.cfg.mode_sizes
    assert spec.cfg.num_params() == jspec.cfg.num_params()


def test_full_width_granite_moe_parameter_counts_match_jax():
    """Base and 4+ed adapter parameters from shapes alone in both
    packages: 1,334,756,352 base parameters (f32 routers)."""
    cfg, jcfg = tconfigs.get_config(GRANITE), jconfigs.get_config(GRANITE)
    jrun, trun = _runs(cfg, jcfg, "4+ed", rank=8)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    assert spec.cfg.mode_sizes == jspec.cfg.mode_sizes == (
        1024, 24, 32, 3, 1024)
    params = TM.init_params(cfg, spec, device="meta")
    got = TM.count_params(params)
    want = JM.count_params(jax.eval_shape(
        lambda: JM.init_params(jcfg, jspec, KEY)))
    assert got == want and got["base"] == GRANITE_PARAMS
    ffn = params["base"]["blocks"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["e_wg"].shape == (24, 32, 1024, 512)
    assert ffn["e_wd"].shape == (24, 32, 512, 1024)
    assert ffn["e_wd"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# moe_ffn and its ties
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ffn_case(arch, variant, cf, seed=0, n=24):
    """``moe_ffn`` of both packages on one numpy input (cached: the 4+ed
    cases compare against the 4d case's run at the same capacity
    factor)."""
    jcfg, jspec, jp, cfg, spec, tp = setup(arch, variant)
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
    x = np.random.default_rng(seed).standard_normal((2, n // 2, 64)) \
        .astype(np.float32)
    jw = jax.tree_util.tree_map(lambda a: a[1], jp["base"]["blocks"][0]
                                ["ffn"])
    tw = {k: v[1] for k, v in tp["base"]["blocks"][0]["ffn"].items()}
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    task = _task(variant)
    jctx = JCtx(jspec, jbc, jax.tree_util.tree_map(lambda a: a[1], jpl),
                None if task is None else jnp.int32(task))
    ctx = AdapterCtx(spec, bc, {k: v[1] for k, v in pl.items()}, task)
    want = jmoe.moe_ffn(jnp.asarray(x), jw, jctx, jcfg)
    got = tmoe.moe_ffn(torch.from_numpy(x), tw, ctx, cfg)
    return got, want, cfg, tw, x


@pytest.mark.parametrize("variant", ["4d", "4+ed"])
@pytest.mark.parametrize("cf", [2.0, 1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, cf, variant):
    """y and the aux losses within 1e-5; at capacity factor 0.5 some
    pairs are dropped (and come out as exact zeros in the combine)."""
    (y, aux), (jy, jaux), cfg, tw, x = _ffn_case(arch, variant, cf)
    assert _rel(y, jy) < TOL
    assert sorted(aux) == sorted(jaux) == ["load_balance", "router_z"]
    for k in aux:
        assert abs(float(aux[k]) - float(jaux[k])) <= TOL * abs(
            float(jaux[k]))
    xf = torch.from_numpy(x).reshape(-1, 64)
    _, _, top_p, top_i = tmoe.router(xf, tw["router"], cfg.experts_per_token)
    cap = tmoe.capacity(cfg, top_i.numel())
    _, _, dest = tmoe.dispatch_plan(top_i, cfg.num_experts, cap)
    dropped = int((dest == cfg.num_experts * cap).sum())
    if cf == 0.5:
        assert dropped > 0
    if arch == GRANITE and cf == 2.0:
        assert dropped == 0      # cf · k / E = 1: the capacity never binds
    if variant == "4+ed":        # the expert delta moves y
        (y0, _), _, _, _, _ = _ffn_case(arch, "4d", cf)
        assert _rel(y0, jy) > 1e-3


def _jax_plan(top_i, n_e, cap):
    """The JAX package's dispatch (``_moe_block``'s lines, local path):
    slot sources and each pair's destination."""
    n, k = top_i.shape
    pairs = n * k
    flat_e = top_i.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(n), k)
    order = jnp.argsort(flat_e)
    se, st = flat_e[order], flat_t[order]
    group = jnp.bincount(se, length=n_e)
    seg_start = jnp.cumsum(group) - group
    pos = jnp.arange(pairs) - seg_start[se]
    dest = jnp.where(pos < cap, se * cap + pos, n_e * cap)
    src = jnp.clip(seg_start[:, None] + jnp.arange(cap)[None], 0, pairs - 1)
    valid = jnp.arange(cap)[None] < group[:, None]
    inv = jnp.argsort(order)
    return (np.asarray(jnp.take(st, src)), np.asarray(valid),
            np.asarray(dest[inv]))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_and_dispatch_match_jax_pair_for_pair(arch):
    """A router whose columns repeat in pairs gives exact ties between
    experts 2j and 2j + 1: the top-k keeps the lower index first as
    ``jax.lax.top_k`` does, and the dispatch (slot sources, valid slots,
    each pair's slot) equals the JAX package's stable-argsort dispatch at
    a capacity that binds; the whole moe_ffn over distinct expert weights
    stays within 1e-5."""
    jcfg, jspec, jp, cfg, spec, tp = setup(arch, "4d")
    cfg = dataclasses.replace(cfg, moe_capacity_factor=0.5)
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)
    x = np.random.default_rng(3).standard_normal((1, 20, 64)) \
        .astype(np.float32)
    w = tp["base"]["blocks"][0]["ffn"]["router"][0].clone()
    w[:, 1::2] = w[:, 0::2]
    tw = {k: v[0] for k, v in tp["base"]["blocks"][0]["ffn"].items()}
    tw["router"] = w
    jw = jax.tree_util.tree_map(lambda a: a[0],
                                jp["base"]["blocks"][0]["ffn"])
    jw["router"] = jnp.asarray(w.numpy())
    xf = torch.from_numpy(x[0])
    logits, probs, top_p, top_i = tmoe.router(xf, w, cfg.experts_per_token)
    jl, jprobs, jtop_p, jtop_i = jmoe._router(jnp.asarray(x[0]),
                                              jw["router"],
                                              cfg.experts_per_token)
    assert np.array_equal(top_i.numpy(), np.asarray(jtop_i))
    assert np.array_equal(top_i.numpy(), np.asarray(
        jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.experts_per_token)[1]))
    assert (probs[:, 0::2] == probs[:, 1::2]).all()
    assert (top_i[:, 0] % 2 == 0).all()     # the lower of each tied pair
    cap = tmoe.capacity(cfg, top_i.numel())
    src, valid, dest = tmoe.dispatch_plan(top_i, cfg.num_experts, cap)
    jsrc, jvalid, jdest = _jax_plan(jnp.asarray(top_i.numpy()),
                                    cfg.num_experts, cap)
    assert np.array_equal(valid.numpy(), jvalid)
    assert np.array_equal(src.numpy()[jvalid], jsrc[jvalid])
    assert np.array_equal(dest.numpy(), jdest)
    assert int((dest == cfg.num_experts * cap).sum()) > 0
    ctx, jctx = AdapterCtx(spec, {}, None), JCtx(jspec, {}, None)
    y, _ = tmoe.moe_ffn(torch.from_numpy(x), tw, ctx, cfg)
    jy, _ = jmoe.moe_ffn(jnp.asarray(x), jw, jctx, jcfg)
    assert _rel(y, jy) < TOL


def test_stable_descending_sort_keeps_the_lower_index_first():
    """The port's top-k among many exact ties (bf16-rounded logits in
    f32) keeps ascending indices, as ``jax.lax.top_k`` does."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1, 0.3, 0.0]] * 3)
    vals, idx = tmoe.top_k(probs, 5)
    assert idx.tolist() == [[1, 2, 4, 6, 3]] * 3
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 5)
    assert np.array_equal(idx.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# forward, decode step and paged step against the JAX model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_forward(arch, variant, jpolicy):
    """The JAX forward of 3 prompts of 11 tokens (scalar task under 4d's
    variants with a task axis) under ``jpolicy``, with its caches:
    (tokens, output). Shared by the forward test and the decode test,
    which steps from these caches."""
    jcfg, jspec, jp, cfg, spec, tp = setup(arch, variant)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 11))
    task = _task(variant)
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    return tokens, JT.forward(
        jp["base"], jcfg, jspec, jbc, jpl, jnp.asarray(tokens),
        task=None if task is None else jnp.int32(task), return_caches=True,
        policy=POLICIES[jpolicy])


@pytest.mark.parametrize("arch,variant,jpolicy", POLICY_CASES)
def test_forward_logits_caches_and_aux_match_jax(arch, variant, jpolicy):
    jcfg, jspec, jp, cfg, spec, tp = setup(arch, variant)
    tokens, want = _jax_forward(arch, variant, jpolicy)
    task = _task(variant)
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    got = TT.forward(tp["base"], cfg, spec, bc, pl, tokens, task=task,
                     return_caches=True, device="cpu")
    assert _rel(got.logits, want.logits) < TOL
    for gc, wc in zip(got.caches, want.caches):
        for name in ("k", "v"):
            assert _rel(gc["self"][name], wc["self"][name]) < TOL
    assert sorted(got.aux) == sorted(want.aux) == ["load_balance",
                                                   "router_z"]
    for k in got.aux:
        assert abs(float(got.aux[k]) - float(want.aux[k])) <= TOL * abs(
            float(want.aux[k]))


@pytest.mark.parametrize("arch,variant,jpolicy", POLICY_CASES)
def test_decode_step_logits_and_caches_match_jax(arch, variant, jpolicy):
    """One decode step of 3 slots at their own positions (and tasks under
    4+1d) from the same prefilled caches: the forward test's JAX run."""
    jcfg, jspec, jp, cfg, spec, tp = setup(arch, variant)
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    s_len = 16
    _, pre = _jax_forward(arch, variant, jpolicy)
    jcaches = jax.tree_util.tree_map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, s_len - c.shape[2]),
                              (0, 0), (0, 0))), pre.caches)
    tcaches = from_jax_numpy(jax.device_get(jcaches), device="cpu")
    pos = np.array([11, 4, 7], np.int32)
    tok = np.array([[5], [77], [5]])
    task = _task(variant, 3)
    want, jnew = JT.decode_step(
        jp["base"], jcfg, jspec, jbc, jpl, jnp.asarray(tok), jcaches,
        jnp.asarray(pos), task=None if task is None else jnp.asarray(task),
        policy=POLICIES[jpolicy])
    got, tnew = TT.decode_step(
        tp["base"], cfg, spec, bc, pl, tok, tcaches, torch.from_numpy(pos),
        task=None if task is None else torch.from_numpy(task), device="cpu")
    assert _rel(got, want) < TOL
    for gc, wc in zip(tnew, jnew):
        for name in ("k", "v"):
            assert _rel(gc["self"][name], wc["self"][name]) < TOL


N, PAGE, P_TAB = 10, 8, 5


@pytest.mark.parametrize("arch,variant,jpolicy", POLICY_CASES)
def test_paged_step_matches_jax(arch, variant, jpolicy):
    """One co-batched paged step over random stale pools: a decoding
    slot with pad columns, two prefilling slots (one running past its
    page into a sentinel page) and an idle all-sentinel slot — every row
    takes expert capacity. Logits and every pool cell within 1e-5."""
    jcfg, jspec, jp, cfg, spec, tp = setup(arch, variant)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (4, 4))
    tables = np.full((4, P_TAB), N, np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[1, :2] = [0, 5]
    tables[2, :1] = [8]
    pos = np.array([13, 5, 6, 0], np.int32)
    sel = np.array([0, 3, 1, 0], np.int32)
    task = _task(variant, 4)
    jc = JT.init_paged_caches(jcfg, N, PAGE, jnp.float32)
    jc = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.5,
                              jnp.float32), jc)
    tc = from_jax_numpy(jax.device_get(jc), device="cpu")
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    want, jnew = JT.paged_step(
        jp["base"], jcfg, jspec, jbc, jpl, jnp.asarray(toks), jc,
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(sel),
        task=None if task is None else jnp.asarray(task),
        policy=POLICIES[jpolicy])
    with torch.inference_mode():
        got, tnew = TT.paged_step(
            tp["base"], cfg, spec, bc, pl, toks, tc,
            torch.from_numpy(tables), torch.from_numpy(pos),
            torch.from_numpy(sel),
            task=None if task is None else torch.from_numpy(task),
            device="cpu")
    assert _rel(got, want) < TOL
    for gc, wc in zip(tnew, jnew):
        for name in ("k", "v"):
            assert _rel(gc["self"][name], wc["self"][name]) < TOL


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_matches_parallel_forward(variant):
    """granite-moe: token-by-token decode over 8 positions equals the
    parallel forward within 1e-5 (f32; the JAX package's case, whose limit
    is 2e-2). Its smoke config routes top-2 of 4 experts at capacity
    factor 2.0, so no pair is dropped at any batch size."""
    _, _, _, cfg, spec, tp = setup(GRANITE, variant)
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    b_, s_ = 2, 8
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b_, s_)))
    task = _task(variant)
    out = TT.forward(tp["base"], cfg, spec, bc, pl, tokens, task=task,
                     device="cpu")
    caches = TT.init_caches(cfg, b_, s_, torch.float32, device="cpu")
    steps = []
    for t in range(s_):
        lg, caches = TT.decode_step(
            tp["base"], cfg, spec, bc, pl, tokens[:, t:t + 1], caches,
            torch.full((b_,), t),
            task=None if task is None else torch.full((b_,), task),
            device="cpu")
        steps.append(lg)
    dec = torch.stack(steps, 1)
    rel = float((dec - out.logits).abs().max() / out.logits.abs().max())
    assert rel < TOL
