"""Shared helpers of the granite-34b / mistral-large-123b engine tests
(``tests/test_torch_gqa_engines*.py``: the dense, the paged and the
int8-KV paged engines, one file each so that ``--dist loadfile`` runs
them in parallel): the request mix, a fresh JAX engine beside a fresh
port engine over the setups of ``tests/test_torch_gqa_models.py``, and
the token-identity check.
"""
import jax
import numpy as np

from repro.config.base import QuantConfig as JQuantConfig
from repro.config.base import ServeConfig as JServeConfig
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch.config.base import QuantConfig, ServeConfig
from repro_torch.serving import Engine, Request

from test_torch_gqa_models import CASES, KEY, _setup  # noqa: F401

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
