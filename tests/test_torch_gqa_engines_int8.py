"""granite-34b and mistral-large-123b served by the port's int8-KV paged
engine against the JAX int8-KV engine (f32, on the CPU).

Over the setups of ``tests/test_torch_gqa_models.py`` — each smoke config
and its variants with G = 12 (24 heads of 16 over 2) and G = 48 (48 heads
of 8 over 1), weights and a 4+1d MetaTT q/v adapter over 3 tasks made by
the JAX package — the port's int8-KV paged engine gives greedy
tokens IDENTICAL to the JAX engine's, with equal dtype / block-byte /
KV-byte counters, below the fp pools' (shared helpers:
``tests/gqa_engine_cases.py``).
"""
import pytest

from repro_torch.serving import Request

from gqa_engine_cases import CASES, _engines, _serve, _setup, _work


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
