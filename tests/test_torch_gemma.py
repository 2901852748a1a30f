"""gemma-7b in the port against the JAX package.

gemma-7b (GeGLU with tanh gelu, the (1 + w) RMS norm, 16 heads of 256, so
q_dim 4096 != d_model 3072) is served on the card through the head_dim 256
instances of K3, K4, #8 and #8q (``chip_smoke.py`` phase 12); here the
CPU tensors run their plain versions. The full config equals the JAX one
field for field, with equal parameter counts (counted on the meta device
and through ``jax.eval_shape``: nothing of full width is allocated). On
the smoke config (2 layers, d_model 64, 4 heads of 32: q_dim 128 !=
d_model), with weights made by the JAX package (its PRNG) and a 4+1d
MetaTT q/v adapter over 3 tasks carried across with
``repro_torch.convert.from_jax_numpy``, the port's prefill and decode
logits and caches are within 1e-5 (f32, relative to the largest value) of
the JAX model's under its reference path and its Pallas kernels in
interpret mode, and the port's dense, paged (shared prefix, cold then
warm) and int8 paged engines give greedy tokens IDENTICAL to the JAX
engines', with equal counters. The model and dense-engine checks run
again on the smoke config with head_dim 256 in both packages (q_dim 1024).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import QuantConfig as JQuantConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import ServeConfig as JServeConfig
from repro.core import tt as jtt
from repro.kernels import dispatch as jdispatch
from repro.models import model as JM
from repro.models import transformer as JT
from repro.peft import api as jpeft
from repro.serving import AdapterRuntime as JRuntime
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch import configs as tconfigs
from repro_torch.config.base import QuantConfig, RunConfig, ServeConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.peft import api as tpeft
from repro_torch.serving import AdapterRuntime, Engine, Request

ARCH = "gemma-7b"
KEY = jax.random.PRNGKey(25)
TOL = 1e-5
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
POLICIES = {"ref": None, "pallas_interpret": jdispatch.PALLAS_INTERPRET}
HEAD_DIMS = [32, 256]
BASE = dict(max_batch=2, cache_len=48, out_cap=8, page_size=8,
            prefill_chunk=4)
PAGED_COUNTERS = ("admitted", "evicted", "prefix_lookups",
                  "prefix_hit_tokens", "prefix_lookup_tokens", "cow_copies",
                  "cache_evictions", "backpressure_waits", "kv_blocks_peak",
                  "tokens_generated")


def _rel(got, want) -> float:
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _runs(cfg, jcfg, rank=4):
    common = dict(adapter_kind="metatt", adapter_variant="4+1d",
                  num_tasks=3, adapter_rank=rank)
    return (JRunConfig(model=jcfg, shape=SHAPES["decode_32k"], **common),
            RunConfig(model=cfg, **common))


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_matches_jax_field_by_field(smoke):
    get = "get_smoke_config" if smoke else "get_config"
    cfg, jcfg = getattr(tconfigs, get)(ARCH), getattr(jconfigs, get)(ARCH)
    assert ARCH in tconfigs.ALL_IDS
    for f in dataclasses.fields(jcfg):
        want = getattr(jcfg, f.name)
        assert getattr(cfg, f.name) == DTYPES.get(want, want), f.name
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert (cfg.q_dim, cfg.kv_dim) == (jcfg.q_dim, jcfg.kv_dim)
    assert cfg.q_dim != cfg.d_model and cfg.mlp == "geglu"
    if not smoke:
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == (
                    28, 3072, 16, 256, 24576, 256000)
        assert cfg.param_dtype == torch.bfloat16
    TT.check_supported(cfg)


def test_full_width_parameter_counts_match_jax():
    """8.54 B base parameters and the 4+1d adapter's, counted from shapes
    alone in both packages."""
    cfg, jcfg = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    jrun, trun = _runs(cfg, jcfg, rank=8)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    assert spec.cfg.mode_sizes == jspec.cfg.mode_sizes
    got = TM.count_params(TM.init_params(cfg, spec, device="meta"))
    want = JM.count_params(jax.eval_shape(
        lambda: JM.init_params(jcfg, jspec, KEY)))
    assert got == want
    assert got["base"] == 8_537_680_896


# ---------------------------------------------------------------------------
# the smoke model against the JAX model, at head_dim 32 and 256
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _setup(head_dim):
    """The smoke config with ``head_dim`` in both packages, 4+1d MetaTT
    on q/v over 3 tasks at rank 4 (``random_tt(scale=0.5)``), made by the
    JAX package; the JAX and port runtimes over the same weights."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               head_dim=head_dim)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                              head_dim=head_dim)
    jrun, trun = _runs(cfg, jcfg)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.5)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    trt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                               tp["frozen"])
    return jcfg, jspec, jp, jrt, cfg, spec, tp, trt


@pytest.mark.parametrize("jpolicy", sorted(POLICIES))
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_prefill_logits_and_caches_match_jax(head_dim, jpolicy):
    jcfg, jspec, jp, _, cfg, spec, tp, _ = _setup(head_dim)
    assert cfg.q_dim == 4 * head_dim != cfg.d_model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11))
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    want = JT.forward(jp["base"], jcfg, jspec, jbc, jpl, jnp.asarray(tokens),
                      task=jnp.int32(1), return_caches=True,
                      policy=POLICIES[jpolicy])
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    got = TT.forward(tp["base"], cfg, spec, bc, pl, tokens, task=1,
                     return_caches=True, device="cpu")
    assert got.logits.dtype == torch.float32
    assert _rel(got.logits, want.logits) < TOL
    for gc, wc in zip(got.caches, want.caches):
        for name in ("k", "v"):
            assert gc["self"][name].shape[-1] == head_dim
            assert _rel(gc["self"][name], wc["self"][name]) < TOL


@pytest.mark.parametrize("jpolicy", sorted(POLICIES))
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_decode_step_logits_and_caches_match_jax(head_dim, jpolicy):
    """One decode step of 2 slots at their own positions and tasks from
    the same prefilled caches: logits and the written caches."""
    jcfg, jspec, jp, _, cfg, spec, tp, _ = _setup(head_dim)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11))
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    s_len = 16
    pre = JT.forward(jp["base"], jcfg, jspec, jbc, jpl, jnp.asarray(tokens),
                     task=jnp.int32(0), return_caches=True)
    jcaches = jax.tree_util.tree_map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, s_len - c.shape[2]),
                              (0, 0), (0, 0))), pre.caches)
    tcaches = from_jax_numpy(jax.device_get(jcaches), device="cpu")
    pos = np.array([11, 4], np.int32)
    tok = np.array([[5], [77]])
    task = np.array([2, 0])
    want, jnew = JT.decode_step(jp["base"], jcfg, jspec, jbc, jpl,
                                jnp.asarray(tok), jcaches, jnp.asarray(pos),
                                task=jnp.asarray(task),
                                policy=POLICIES[jpolicy])
    got, tnew = TT.decode_step(tp["base"], cfg, spec, bc, pl, tok, tcaches,
                               torch.from_numpy(pos),
                               task=torch.from_numpy(task), device="cpu")
    assert _rel(got, want) < TOL
    for gc, wc in zip(tnew, jnew):
        for name in ("k", "v"):
            assert _rel(gc["self"][name], wc["self"][name]) < TOL


# ---------------------------------------------------------------------------
# the engines against the JAX engines
# ---------------------------------------------------------------------------


def _work(vocab, n=5, prefix=0):
    """``n`` mixed-task requests [(prompt, max_new, task)]; with
    ``prefix`` the even ones start with one shared ``prefix``-token run
    (ending mid-page, so a warm match copies that page on write)."""
    shared = np.asarray(jax.random.randint(KEY, (prefix,), 0, vocab))
    work = []
    for i in range(n):
        own = np.asarray(jax.random.randint(jax.random.PRNGKey(i), (4 + i,),
                                            0, vocab))
        p = np.concatenate([shared, own]) if i % 2 == 0 else own
        work.append((p, 5 + (i % 3), i % 3))
    return work


def _engines(head_dim=32, **kw):
    """A fresh JAX engine and a fresh port engine on ``BASE`` + ``kw``."""
    jcfg, _, _, jrt, cfg, _, _, trt = _setup(head_dim)
    quant = kw.pop("quant", {})
    sv = dict(BASE, **kw)
    return (JEngine(jcfg, jrt, serve=JServeConfig(quant=JQuantConfig(**quant),
                                                  **sv)),
            Engine(cfg, trt, serve=ServeConfig(quant=QuantConfig(**quant),
                                               **sv), device="cpu"))


def _serve(jeng, teng, work, counters=()):
    """``work`` through both engines: tokens identical, ``counters`` of
    ``last_stats`` equal. Returns the tokens."""
    want = [np.asarray(o).tolist() for o in jeng.generate(
        [JRequest(p, n, task=t) for p, n, t in work])]
    got = [o.tolist() for o in teng.generate(
        [Request(p, n, task=t) for p, n, t in work])]
    assert got == want
    for name in counters:
        assert getattr(teng.last_stats, name) == \
            getattr(jeng.last_stats, name), name
    assert all(r.status == "FINISHED" for r in teng.last_results)
    return got


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_dense_engine_token_identical_to_jax(head_dim):
    """5 mixed-task requests through 2 dense slots: tokens and admission
    stats equal; the task axis routes (one prompt under 3 tasks)."""
    vocab = _setup(head_dim)[4].vocab_size
    jeng, teng = _engines(head_dim, cache_mode="dense")
    work = _work(vocab)
    got = _serve(jeng, teng, work, ("admitted", "evicted",
                                    "tokens_generated"))
    assert teng.last_stats.admitted == 5 and teng.last_stats.evicted == 5
    assert [len(t) for t in got] == [n for _, n, _ in work]
    per_task = _serve(jeng, teng, [(work[0][0], 5, k) for k in range(3)])
    assert len({tuple(t) for t in per_task}) > 1


def test_paged_engine_shared_prefix_token_identical_to_jax():
    """The paged engine with a 10-token shared prefix, cold then warm:
    tokens identical to the JAX paged engine's and the port's dense
    engine's; prefix hits, COW and peak blocks equal; no leaked block."""
    work = _work(_setup(32)[4].vocab_size, prefix=10)
    jeng, teng = _engines()
    cold = _serve(jeng, teng, work, PAGED_COUNTERS)
    warm = _serve(jeng, teng, work, PAGED_COUNTERS)
    assert warm == cold
    st = teng.last_stats
    assert st.prefix_hit_rate > 0 and st.cow_copies >= 1
    assert teng.leaked_blocks() == 0
    _, dense = _engines(cache_mode="dense")
    assert [o.tolist() for o in dense.generate(
        [Request(p, n, task=t) for p, n, t in work])] == cold


def test_int8_paged_engine_token_identical_to_jax():
    """Int8 weights and int8 KV pools (f32 per-cell scales): tokens
    identical to the JAX int8 engine's; dtypes, block bytes and
    kv_bytes_peak equal and below the fp pools'; warm equals cold."""
    work = _work(_setup(32)[4].vocab_size, prefix=10)
    stats = ("weights_dtype", "kv_dtype", "num_blocks", "block_bytes",
             "kv_blocks_peak", "kv_bytes_peak", "prefix_hit_tokens",
             "cow_copies", "tokens_generated")
    jeng, teng = _engines(quant=dict(weights="int8", kv="int8"))
    cold = _serve(jeng, teng, work, stats)
    assert (teng.last_stats.weights_dtype, teng.last_stats.kv_dtype) == (
        "int8", "int8")
    _, fp = _engines()
    fp.generate([Request(p, n, task=t) for p, n, t in work])
    assert teng.last_stats.kv_bytes_peak < fp.last_stats.kv_bytes_peak
    assert _serve(jeng, teng, work, stats) == cold
    assert teng.leaked_blocks() == 0


def test_entry_points_default_to_cuda():
    """The model's init and the engine run on the CUDA device unless the
    caller asks for the CPU: without a card they raise rather than fall
    back."""
    _, _, _, _, cfg, spec, _, trt = _setup(32)
    if torch.cuda.is_available():
        assert Engine(cfg, trt).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(cfg, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, trt)
    assert Engine(cfg, trt, device="cpu").device.type == "cpu"
