"""granite-34b and mistral-large-123b served by the port's dense engine
against the JAX dense engine (f32, on the CPU).

Over the setups of ``tests/test_torch_gqa_models.py`` — each smoke config
and its variants with G = 12 (24 heads of 16 over 2) and G = 48 (48 heads
of 8 over 1), weights and a 4+1d MetaTT q/v adapter over 3 tasks made by
the JAX package — the port's dense engine gives greedy tokens
IDENTICAL to the JAX engine's, with equal admission counters; the task
axis routes. The paged and int8-KV paged engines are held in
``tests/test_torch_gqa_engines_paged.py`` and
``tests/test_torch_gqa_engines_int8.py`` (shared helpers:
``tests/gqa_engine_cases.py``). On the card the same engines launch K4,
#8 and #8q at these groups (``chip_smoke.py`` phase 14).
"""
import pytest

from gqa_engine_cases import CASES, _engines, _serve, _setup, _work


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
