"""The port's paged model step against the JAX package's.

f32 weights made by the JAX package (smoke stablelm-1.6b, 4+1d MetaTT over
3 tasks) and carried across with ``convert.from_jax_numpy``. The port's
``init_paged_caches``, ``copy_cache_block`` and ``paged_step`` (its kernel
wrappers run their plain versions on the CPU) are held against
``repro.models.transformer`` under both the JAX reference path
(``policy=None``) and its Pallas kernels in interpret mode. Logits within
1e-5 of the largest logit; every pool cell within 1e-5 of the largest
pool value after the in-place write, and cells no write may reach
bit-identical to what they held.
"""
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
from repro.models import transformer as JT
from repro.peft import api as jpeft

from repro_torch import configs as tconfigs
from repro_torch.config.base import RunConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.peft import api as tpeft

KEY = jax.random.PRNGKey(5)
TOL = 1e-5
N, PAGE, P_TAB = 10, 8, 5
POLICIES = {"ref": None, "pallas_interpret": jdispatch.PALLAS_INTERPRET}


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jconfigs.get_smoke_config("stablelm-1.6b")
    jspec = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES["decode_32k"], adapter_kind="metatt",
        adapter_variant="4+1d", num_tasks=3, adapter_rank=4))
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.8)}
    cfg = tconfigs.get_smoke_config("stablelm-1.6b")
    spec = TM.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant="4+1d",
        num_tasks=3, adapter_rank=4))
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jspec, jp, cfg, spec, tp


def _pools(jcfg, seed):
    """Paged pools filled with random values (stale cells of earlier
    requests), as a JAX pytree and as the port's tensors."""
    rng = np.random.default_rng(seed)
    jc = JT.init_paged_caches(jcfg, N, PAGE, jnp.float32)
    jc = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.5,
                              jnp.float32), jc)
    return jc, from_jax_numpy(jax.device_get(jc), device="cpu")


def _leaves(caches):
    return [c["self"][k] for c in caches for k in ("k", "v")]


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _step(toks, tables, pos, sel, task, policy, tpolicy, seed=0):
    jcfg, jspec, jp, cfg, spec, tp = _setup()
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], {})
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], {})
    jc, tc = _pools(jcfg, seed)
    before = [t.clone() for t in _leaves(tc)]
    want, jnew = JT.paged_step(
        jp["base"], jcfg, jspec, jbc, jpl, jnp.asarray(toks), jc,
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(sel),
        task=jnp.asarray(task), policy=POLICIES[policy])
    with torch.inference_mode():
        got, tnew = TT.paged_step(
            tp["base"], cfg, spec, bc, pl, toks, tc, torch.from_numpy(tables),
            torch.from_numpy(pos), torch.from_numpy(sel),
            task=torch.from_numpy(task), policy=tpolicy, device="cpu")
    assert tnew is tc                   # the pools are written in place
    return got, want, before, _leaves(tc), _leaves(jnew)


def _mixed_step():
    """Slot 0 decodes at position 13 (one real token, pad columns), slot 1
    prefills 4 prompt tokens from 5, slot 2 prefills its last 2 tokens
    from 0 — its pad columns run past its one allocated page into a
    sentinel page — slot 3 is idle (all-sentinel row)."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, _setup()[3].vocab_size, (4, 4))
    tables = np.full((4, P_TAB), N, np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[1, :2] = [0, 5]
    tables[2, :1] = [8]
    pos = np.array([13, 5, 6, 0], np.int32)
    sel = np.array([0, 3, 1, 0], np.int32)
    task = np.array([2, 0, 1, 0], np.int32)
    return toks, tables, pos, sel, task


@pytest.mark.parametrize("policy,tpolicy", [
    ("ref", None), ("pallas_interpret", None), ("ref", tdispatch.REF)])
def test_paged_step_matches_jax(policy, tpolicy):
    toks, tables, pos, sel, task = _mixed_step()
    got, want, before, tpools, jpools = _step(toks, tables, pos, sel, task,
                                              policy, tpolicy)
    assert got.shape == want.shape
    assert _rel(got, want) < TOL
    for t, j in zip(tpools, jpools):
        assert _rel(t, j) < TOL
    # block 2 (free) and the cells past slot 2's page are never written
    for t, b in zip(tpools, before):
        for blk in (2, 4, 6, 9):
            assert torch.equal(t[:, blk], b[:, blk])


def test_sentinel_and_out_of_table_writes_leave_every_block_untouched():
    """Every write of this step goes through a sentinel entry or past the
    table (positions >= P_TAB * PAGE): no pool cell may change, though the
    clamped reads of block N - 1 feed the (discarded) outputs."""
    toks, _, _, sel, task = _mixed_step()
    tables = np.full((4, P_TAB), N, np.int32)
    tables[1, :] = [0, 5, 2, 4, 6]          # slot 1 sits past its table
    pos = np.array([0, P_TAB * PAGE, 17, 3], np.int32)
    got, want, before, tpools, jpools = _step(toks, tables, pos, sel, task,
                                              "ref", None, seed=1)
    # these rows attend random pool contents (the engine discards such
    # outputs); slot 1's queries at positions 40..43 attend all 40 random
    # cells, where the two frameworks' f32 RoPE and sums, an ulp apart,
    # are amplified by the peaked softmax to ~1.2e-5 of the largest logit
    assert _rel(got, want) < 1e-4
    for t, b, j in zip(tpools, before, jpools):
        assert torch.equal(t, b)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_init_paged_caches_and_copy_cache_block_match_jax():
    jcfg, _, _, cfg, _, _ = _setup()
    jc, tc = _pools(jcfg, 2)
    fresh = TT.init_paged_caches(cfg, N, PAGE, torch.float32, device="cpu")
    jfresh = JT.init_paged_caches(jcfg, N, PAGE, jnp.float32)
    for t, j in zip(_leaves(fresh), _leaves(jfresh)):
        assert tuple(t.shape) == j.shape and not t.any()
    jc = JT.copy_cache_block(jc, 3, 7)
    TT.copy_cache_block(tc, 3, 7)
    jc = JT.copy_cache_block(jc, 1, N)          # sentinel dst: dropped
    TT.copy_cache_block(tc, 1, N)
    for t, j in zip(_leaves(tc), _leaves(jc)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert torch.equal(t[:, 7], t[:, 3])
