"""granite-34b and mistral-large-123b served by the port's paged engine
against the JAX paged engine (f32, on the CPU).

Over the setups of ``tests/test_torch_gqa_models.py`` — each smoke config
and its variants with G = 12 (24 heads of 16 over 2) and G = 48 (48 heads
of 8 over 1), weights and a 4+1d MetaTT q/v adapter over 3 tasks made by
the JAX package — the port's paged engine with a shared prefix,
cold then warm, gives greedy tokens IDENTICAL to the JAX paged engine's
and to the port's dense engine's, with equal prefix / COW / peak-block
counters and no leaked block (shared helpers:
``tests/gqa_engine_cases.py``).
"""
import pytest

from repro_torch.serving import Request

from gqa_engine_cases import (CASES, PAGED_COUNTERS, _engines, _serve,
                              _setup, _work)


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
