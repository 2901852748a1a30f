"""granite-34b and mistral-large-123b served by the port's engines
against the JAX engines (f32, on the CPU).

Over the setups of ``tests/test_torch_gqa_models.py`` — each smoke config
and its variants with G = 12 (24 heads of 16 over 2) and G = 48 (48 heads
of 8 over 1), weights and a 4+1d MetaTT q/v adapter over 3 tasks made by
the JAX package — the port's dense, paged (a shared prefix, cold then
warm) and int8-KV paged engines give greedy tokens IDENTICAL to the JAX
engines', with equal admission / prefix / COW / peak-block / KV-byte
counters and no leaked block. On the card the same engines launch K4, #8
and #8q at these groups (``chip_smoke.py`` phase 14).
"""
import jax
import numpy as np
import pytest

from repro.config.base import QuantConfig as JQuantConfig
from repro.config.base import ServeConfig as JServeConfig
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch.config.base import QuantConfig, ServeConfig
from repro_torch.serving import Engine, Request

from test_torch_gqa_models import CASES, KEY, _setup

BASE = dict(max_batch=2, cache_len=48, out_cap=8, page_size=8,
            prefill_chunk=4)
PAGED_COUNTERS = ("admitted", "evicted", "prefix_lookups",
                  "prefix_hit_tokens", "prefix_lookup_tokens", "cow_copies",
                  "cache_evictions", "backpressure_waits", "kv_blocks_peak",
                  "tokens_generated")


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


def _engines(arch, variant, **kw):
    """A fresh JAX engine and a fresh port engine on ``BASE`` + ``kw``."""
    jcfg, _, _, jrt, cfg, _, _, trt = _setup(arch, variant)
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


@pytest.mark.parametrize("arch,variant", CASES)
def test_dense_engine_token_identical_to_jax(arch, variant):
    """5 mixed-task requests through 2 dense slots: tokens and admission
    stats equal; the task axis routes (one prompt under 3 tasks)."""
    vocab = _setup(arch, variant)[4].vocab_size
    jeng, teng = _engines(arch, variant, cache_mode="dense")
    work = _work(vocab)
    got = _serve(jeng, teng, work, ("admitted", "evicted",
                                    "tokens_generated"))
    assert teng.last_stats.admitted == 5 and teng.last_stats.evicted == 5
    assert [len(t) for t in got] == [n for _, n, _ in work]
    per_task = _serve(jeng, teng, [(work[0][0], 5, k) for k in range(3)])
    assert len({tuple(t) for t in per_task}) > 1


@pytest.mark.parametrize("arch,variant", CASES)
def test_paged_engine_shared_prefix_token_identical_to_jax(arch, variant):
    """The paged engine with a 10-token shared prefix, cold then warm:
    tokens identical to the JAX paged engine's and the port's dense
    engine's; prefix hits, COW and peak blocks equal; no leaked block."""
    work = _work(_setup(arch, variant)[4].vocab_size, prefix=10)
    jeng, teng = _engines(arch, variant)
    cold = _serve(jeng, teng, work, PAGED_COUNTERS)
    warm = _serve(jeng, teng, work, PAGED_COUNTERS)
    assert warm == cold
    st = teng.last_stats
    assert st.prefix_hit_rate > 0 and st.cow_copies >= 1
    assert teng.leaked_blocks() == 0
    pools = teng._paged_caches[0]["self"]
    assert pools["k"].shape[-2] == _setup(arch, variant)[4].num_kv_heads
    _, dense = _engines(arch, variant, cache_mode="dense")
    assert [o.tolist() for o in dense.generate(
        [Request(p, n, task=t) for p, n, t in work])] == cold


@pytest.mark.parametrize("arch,variant", CASES)
def test_int8_paged_engine_token_identical_to_jax(arch, variant):
    """int8 KV pools (f32 per-cell scales) over the fp base, as phase 14's
    int8 cell: tokens identical to the JAX int8-KV engine's; dtypes,
    block bytes and kv_bytes_peak equal and below the fp pools'; warm
    equals cold."""
    work = _work(_setup(arch, variant)[4].vocab_size, prefix=10)
    stats = ("weights_dtype", "kv_dtype", "num_blocks", "block_bytes",
             "kv_blocks_peak", "kv_bytes_peak", "prefix_hit_tokens",
             "cow_copies", "tokens_generated")
    jeng, teng = _engines(arch, variant, quant=dict(kv="int8"))
    cold = _serve(jeng, teng, work, stats)
    assert teng.last_stats.kv_dtype == "int8"
    _, fp = _engines(arch, variant)
    fp.generate([Request(p, n, task=t) for p, n, t in work])
    assert teng.last_stats.kv_bytes_peak < fp.last_stats.kv_bytes_peak
    assert _serve(jeng, teng, work, stats) == cold
    assert teng.leaked_blocks() == 0
