"""The port's speculative decode against the JAX package's
(``src/repro/serving/speculative.py`` and the engine's spec loops),
mirroring the single-device cases of tests/test_speculative.py.

Weights are made once by the JAX package (smoke stablelm-1.6b, 4+1d
MetaTT over 3 tasks at rank 4, ``random_tt(scale=0.8)``), carried across
with ``repro_torch.convert.from_jax_numpy``, and both engines serve in
f32 on the CPU. Greedy tokens must be IDENTICAL to the JAX speculative
engine's and to the port's own non-speculative engine's, in the dense
and paged modes, with the same draft / accept counts as the JAX engine.
Rejection sampling draws from a ``torch.Generator``, which cannot give
JAX's random stream: it is held to the target distribution instead.
"""
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
from repro.config.base import SpecConfig as JSpecConfig
from repro.core import tt as jtt
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving import AdapterRuntime as JRuntime
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import speculative as jspec

from repro_torch import configs as tconfigs
from repro_torch.config.base import (QuantConfig, RunConfig, ServeConfig,
                                     SpecConfig)
from repro_torch.convert import from_jax_numpy
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.peft import api as tpeft
from repro_torch.serving import (AdapterRuntime, Engine, Request,
                                 SamplingConfig)
from repro_torch.serving import speculative as tspec

KEY = jax.random.PRNGKey(0)
ARCH = "stablelm-1.6b"
VOCAB = jconfigs.get_smoke_config(ARCH).vocab_size
BASE = dict(max_batch=2, cache_len=32, out_cap=8, page_size=8,
            prefill_chunk=4)


@functools.lru_cache(maxsize=None)
def _weights(variant="4+1d", num_tasks=3):
    jcfg = jconfigs.get_smoke_config(ARCH)
    jspec_ = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES["decode_32k"], adapter_kind="metatt",
        adapter_variant=variant, num_tasks=num_tasks, adapter_rank=4))
    jp = JM.init_params(jcfg, jspec_, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec_.cfg.mode_sizes, 4,
                                            scale=0.8)}
    cfg = tconfigs.get_smoke_config(ARCH)
    spec = TM.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant=variant,
        num_tasks=num_tasks, adapter_rank=4))
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jspec_, jp, cfg, spec, tp


@functools.lru_cache(maxsize=None)
def _runtimes(mode="live"):
    jcfg, jspec_, jp, cfg, spec, tp = _weights()
    kw = dict(model_cfg=cfg, task=1) if mode == "merged" else {}
    jkw = dict(model_cfg=jcfg, task=1) if mode == "merged" else {}
    jrt = JRuntime.build(mode, jp["base"], jspec_, jp["adapter"],
                         jp["frozen"], **jkw)
    trt = AdapterRuntime.build(mode, tp["base"], spec, tp["adapter"],
                               tp["frozen"], **kw)
    return jcfg, jrt, cfg, trt


def _requests(n=4, tasks=3):
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(i), (4 + i,),
                                             0, VOCAB)) for i in range(n)]
    return [(p, 5 + (i % 3), i % tasks) for i, p in enumerate(prompts)]


def _serve_port(trt, cfg, reqs, spec=SpecConfig(), sampling=None,
                quant=QuantConfig(), **kw):
    sv = ServeConfig(**dict(BASE, quant=quant, spec=spec, **kw))
    eng = Engine(cfg, trt, serve=sv, device="cpu",
                 **({"sampling": sampling} if sampling else {}))
    out = eng.generate([Request(p, n, task=t) for p, n, t in reqs])
    return [o.tolist() for o in out], eng


def _serve_jax(jrt, jcfg, reqs, spec, quant=JQuantConfig(), **kw):
    sv = JServeConfig(**dict(BASE, quant=quant, spec=spec, **kw))
    eng = JEngine(jcfg, jrt, serve=sv)
    out = eng.generate([JRequest(p, n, task=t) for p, n, t in reqs])
    return [np.asarray(o).tolist() for o in out], eng


def _spec_pair(k, rank, stride=1):
    return (SpecConfig(spec_k=k, draft_rank=rank, draft_layer_stride=stride),
            JSpecConfig(spec_k=k, draft_rank=rank,
                        draft_layer_stride=stride))


# ---------------------------------------------------------------------------
# greedy token identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_spec_greedy_token_identical_to_jax_and_non_spec(mode):
    """Rank-truncated drafter, both cache modes: the port's speculative
    tokens equal the JAX speculative engine's and the port's own
    non-speculative engine's; the draft / accept counts equal JAX's."""
    jcfg, jrt, cfg, trt = _runtimes()
    reqs = _requests()
    spec, jspec_cfg = _spec_pair(3, 2)
    base, _ = _serve_port(trt, cfg, reqs, cache_mode=mode)
    out, eng = _serve_port(trt, cfg, reqs, spec=spec, cache_mode=mode)
    jout, jeng = _serve_jax(jrt, jcfg, reqs, jspec_cfg, cache_mode=mode)
    assert out == base == jout
    st, jst = eng.last_stats, jeng.last_stats
    assert st.spec_k == 3 and st.spec_steps > 0 and st.draft_tokens > 0
    assert 0.0 <= st.acceptance_rate <= 1.0
    assert (st.draft_tokens, st.accepted_tokens) == (
        jst.draft_tokens, jst.accepted_tokens)
    assert st.spec_steps == jst.spec_steps
    assert st.tokens_per_step == pytest.approx(jst.tokens_per_step)


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_spec_layer_stride_greedy_token_identical(mode):
    """A layer-strided drafter is a worse approximation; greedy identity
    does not depend on drafter quality."""
    jcfg, jrt, cfg, trt = _runtimes()
    reqs = _requests()
    spec, jspec_cfg = _spec_pair(2, 2, stride=2)
    base, _ = _serve_port(trt, cfg, reqs, cache_mode=mode)
    out, eng = _serve_port(trt, cfg, reqs, spec=spec, cache_mode=mode)
    jout, jeng = _serve_jax(jrt, jcfg, reqs, jspec_cfg, cache_mode=mode)
    assert out == base == jout
    assert eng._nb_draft == -(-cfg.num_super_blocks // 2)
    assert eng.last_stats.accepted_tokens == jeng.last_stats.accepted_tokens


@pytest.mark.parametrize("runtime", ["lora", "merged"])
def test_spec_greedy_across_runtimes(runtime):
    """The lora runtime truncates its pre-folded A; merged keeps the full
    (folded) weights: both token-identical to their non-spec engines and
    to the JAX speculative engine."""
    jcfg, jrt, cfg, trt = _runtimes(runtime)
    reqs = _requests()
    if runtime == "merged":
        reqs = [r for r in reqs if r[2] == 1]
    spec, jspec_cfg = _spec_pair(3, 2)
    base, _ = _serve_port(trt, cfg, reqs)
    out, _ = _serve_port(trt, cfg, reqs, spec=spec)
    jout, _ = _serve_jax(jrt, jcfg, reqs, jspec_cfg)
    assert out == base == jout


def test_spec_greedy_int8_kv():
    jcfg, jrt, cfg, trt = _runtimes()
    reqs = _requests()
    spec, jspec_cfg = _spec_pair(3, 2)
    base, _ = _serve_port(trt, cfg, reqs, quant=QuantConfig(kv="int8"))
    out, eng = _serve_port(trt, cfg, reqs, spec=spec,
                           quant=QuantConfig(kv="int8"))
    jout, _ = _serve_jax(jrt, jcfg, reqs, jspec_cfg,
                         quant=JQuantConfig(kv="int8"))
    assert out == base == jout
    assert eng._draft_pools[0]["self"]["k"].dtype == torch.int8


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_spec_full_rank_drafter_accepts_everything(mode):
    """draft_rank 0 and stride 1 make the drafter the target: every draft
    is accepted and a decode step commits spec_k + 1 tokens."""
    _, _, cfg, trt = _runtimes()
    reqs = [(np.arange(4) % VOCAB, 8, 0)]
    base, _ = _serve_port(trt, cfg, reqs, cache_mode=mode)
    out, eng = _serve_port(trt, cfg, reqs, spec=SpecConfig(spec_k=3),
                           cache_mode=mode)
    assert out == base
    assert eng.last_stats.acceptance_rate == 1.0


def test_spec_warm_prefix_cache_token_identical():
    """Prefix hits reuse blocks carrying both the target's and the
    drafter's KV (same tables, parallel pools): warm output equals cold."""
    _, _, cfg, trt = _runtimes()
    reqs = _requests()
    cold, eng = _serve_port(trt, cfg, reqs,
                            spec=SpecConfig(spec_k=3, draft_rank=2))
    assert eng.last_stats.prefix_hit_rate == 0.0
    warm = [o.tolist() for o in eng.generate(
        [Request(p, n, task=t) for p, n, t in reqs])]
    assert warm == cold
    assert eng.last_stats.prefix_hit_rate > 0.0
    assert eng.leaked_blocks() == 0


def test_spec_no_leaked_blocks_and_byte_accounting():
    """The drafter's pools ride the same block tables: no extra blocks,
    every block back on the free list (prefix cache off), and a block's
    bytes count the drafter's region (stride 1: exactly double)."""
    _, _, cfg, trt = _runtimes()
    reqs = _requests()
    _, base_eng = _serve_port(trt, cfg, reqs, prefix_cache=False)
    _, eng = _serve_port(trt, cfg, reqs, prefix_cache=False,
                         spec=SpecConfig(spec_k=3, draft_rank=2))
    assert eng.bm.free_blocks == eng._num_blocks
    assert eng.leaked_blocks() == 0
    st, bst = eng.last_stats, base_eng.last_stats
    assert st.kv_blocks_peak == bst.kv_blocks_peak
    assert st.block_bytes == 2 * bst.block_bytes
    _, dense = _serve_port(trt, cfg, reqs, cache_mode="dense",
                           spec=SpecConfig(spec_k=2, draft_layer_stride=2))
    _, dense0 = _serve_port(trt, cfg, reqs, cache_mode="dense")
    assert dense.last_stats.block_bytes == dense0.last_stats.block_bytes + (
        dense0.last_stats.block_bytes // cfg.num_super_blocks
        * dense._nb_draft)


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_spec_temperature_engine_smoke(mode):
    """Sampling methods run through the rejection-sampling accept path:
    every request gets its tokens, in the vocabulary, and the same
    generator seed gives the same tokens."""
    _, _, cfg, trt = _runtimes()
    reqs = _requests(n=3)
    sc = SamplingConfig(method="top_k", top_k=8, temperature=0.9,
                        repetition_penalty=1.2)
    outs = []
    for _ in range(2):
        out, eng = _serve_port(trt, cfg, reqs, sampling=sc, cache_mode=mode,
                               spec=SpecConfig(spec_k=2, draft_rank=2))
        outs.append(out)
        assert [len(o) for o in out] == [n for _, n, _ in reqs]
        assert all(0 <= t < cfg.padded_vocab for o in out for t in o)
        assert eng.last_stats.draft_tokens > 0
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the multi-token decode step
# ---------------------------------------------------------------------------


def test_multi_token_decode_step_matches_jax_and_sequential_steps():
    """decode_step with T = 3 columns: every column's logits equal the JAX
    decode_step(all_logits=True)'s (f32 1e-5) and three single-token
    steps' (the same code a column); writes past the cache end drop."""
    jcfg, jspec_, jp, cfg, spec, tp = _weights("4d", 0)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, VOCAB, (2, 6))
    toks = rng.integers(0, VOCAB, (2, 3))
    pos = np.array([6, 14])          # row 1 overhangs a 16-cell cache
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    jbc, jpl = JM.peft_api.adapter_factors(jspec_, jp["adapter"],
                                           jp["frozen"])

    def port_caches():
        out = TT.forward(tp["base"], cfg, spec, bc, pl, prompt,
                         return_caches=True, device="cpu")
        c = TT.init_caches(cfg, 2, 16, cfg.compute_dtype, device="cpu")
        for b in range(2):
            one = [{"self": {n: x["self"][n][:, b:b + 1] for n in ("k", "v")}}
                   for x in out.caches]
            TT.insert_cache_slot(c, one, b)
        return c
    multi, c_multi = TT.decode_step(tp["base"], cfg, spec, bc, pl, toks,
                                    port_caches(), torch.tensor(pos),
                                    all_logits=True, device="cpu")
    c_seq = port_caches()
    for j in range(3):
        lg, _ = TT.decode_step(tp["base"], cfg, spec, bc, pl,
                               toks[:, j:j + 1], c_seq,
                               torch.tensor(pos + j), device="cpu")
        torch.testing.assert_close(multi[:, j], lg, rtol=1e-5, atol=1e-5)
    for a, b in zip(c_multi, c_seq):
        torch.testing.assert_close(a["self"]["k"], b["self"]["k"])
    jout = JT.forward(jp["base"], jcfg, jspec_, jbc, jpl,
                      jnp.asarray(prompt))
    jc = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 10), (0, 0), (0, 0))),
        jout.caches)
    jl, _ = JT.decode_step(jp["base"], jcfg, jspec_, jbc, jpl,
                           jnp.asarray(toks), jc, jnp.asarray(pos),
                           all_logits=True)
    np.testing.assert_allclose(multi.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the accept rules and the drafter's factors
# ---------------------------------------------------------------------------


def test_greedy_verify_prefix_rule():
    draft = torch.tensor([[5, 7, 9], [5, 7, 9], [1, 7, 9]])
    verify = torch.tensor([[5, 7, 9, 2], [5, 8, 9, 2], [5, 7, 9, 2]])
    emitted, n = tspec.greedy_verify(draft, verify)
    assert n.tolist() == [3, 1, 0]
    assert emitted.tolist() == verify.tolist()
    jem, jn = jspec.greedy_verify(jnp.asarray(draft.numpy()),
                                  jnp.asarray(verify.numpy()))
    assert n.tolist() == np.asarray(jn).tolist()


def test_rejection_sampling_preserves_distribution():
    """The first committed token under a deliberately wrong drafter
    follows the target p (atol 0.03 over 4000 draws, as the JAX test),
    and a perfect drafter (q == p) accepts everything."""
    v, k, trials = 4, 1, 4000
    p = torch.tensor([0.55, 0.25, 0.15, 0.05])
    q = torch.tensor([0.10, 0.40, 0.30, 0.20])
    gen = torch.Generator().manual_seed(1)
    d = torch.multinomial(q.expand(trials, v), 1, replacement=True,
                          generator=gen)                       # (trials, 1)
    emitted, n = tspec.rejection_verify(gen, d, q.expand(trials, k, v),
                                        p.expand(trials, k + 1, v))
    freq = torch.bincount(emitted[:, 0], minlength=v).float() / trials
    torch.testing.assert_close(freq, p, rtol=0, atol=0.03)
    dp = torch.multinomial(p.expand(trials, v), 1, replacement=True,
                           generator=gen)
    _, n_perfect = tspec.rejection_verify(gen, dp, p.expand(trials, k, v),
                                          p.expand(trials, k + 1, v))
    assert float(n_perfect.float().mean()) == 1.0
    assert float(n_perfect.float().mean()) > float(n.float().mean()) + 0.2
    # two drafts: emitted[:, :n] are the drafts, the rest the correction
    d2 = torch.tensor([[1, 2]])
    em, n2 = tspec.rejection_verify(gen, d2, torch.full((1, 2, v), 0.25),
                                    torch.full((1, 3, v), 0.25))
    assert n2.tolist() == [2] and em[0, :2].tolist() == [1, 2]


def test_truncate_factors_rank_nesting_matches_jax():
    """The leading bond columns: the truncated composition equals the full
    one with the trailing columns zeroed, and equals JAX's truncation."""
    rng = np.random.default_rng(2)
    g1, c, g4 = (rng.standard_normal(s).astype(np.float32)
                 for s in ((6, 4), (3, 2, 4, 4), (4, 5)))
    bc, pl = tspec.truncate_factors(
        "metatt", {"g1": torch.from_numpy(g1), "g4": torch.from_numpy(g4)},
        {"c": torch.from_numpy(c)}, 2)
    assert bc["g1"].shape == (6, 2) and bc["g4"].shape == (2, 5)
    assert pl["c"].shape == (3, 2, 2, 2)
    g1z, cz, g4z = g1.copy(), c.copy(), g4.copy()
    g1z[:, 2:], cz[..., 2:, :], cz[..., :, 2:], g4z[2:] = 0, 0, 0, 0
    full = np.einsum("dr,lmrs,se->lmde", g1z, cz, g4z)
    trunc = torch.einsum("dr,lmrs,se->lmde", bc["g1"], pl["c"], bc["g4"])
    np.testing.assert_allclose(trunc.numpy(), full, rtol=1e-5, atol=1e-5)
    jbc, jpl = jspec.truncate_factors(
        "metatt", {"g1": jnp.asarray(g1), "g4": jnp.asarray(g4)},
        {"c": jnp.asarray(c)}, 2)
    for got, want in ((bc["g1"], jbc["g1"]), (bc["g4"], jbc["g4"]),
                      (pl["c"], jpl["c"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # lora-form A, plain lora and the kinds that keep full rank
    a = torch.ones(3, 2, 6, 4)
    assert tspec.truncate_factors("metatt", {"g4": torch.ones(4, 5)},
                                  {"a": a}, 3)[1]["a"].shape == (3, 2, 6, 3)
    lo = tspec.truncate_factors("lora", {}, {"a": a, "b": torch.ones(
        3, 2, 4, 5)}, 1)[1]
    assert lo["a"].shape[-1] == 1 and lo["b"].shape[-2] == 1
    vera = ({"a": torch.ones(6, 4)}, {"d": torch.ones(3, 2, 4)})
    assert tspec.truncate_factors("vera", *vera, 2) == vera
    assert tspec.truncate_factors("metatt", *vera, 0) == vera


def test_stride_base_and_per_layer_match_jax():
    jcfg, jspec_, jp, cfg, spec, tp = _weights("4d", 0)
    sc = SpecConfig(spec_k=2, draft_rank=2, draft_layer_stride=2)
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    dbase, dbc, dpl, nb = tspec.build_drafter(sc, "metatt", tp["base"], bc,
                                              pl, len(cfg.block_pattern))
    jbc, jpl = JM.peft_api.adapter_factors(jspec_, jp["adapter"],
                                           jp["frozen"])
    jd = jspec.build_drafter(JSpecConfig(spec_k=2, draft_rank=2,
                                         draft_layer_stride=2), "metatt",
                             jp["base"], jbc, jpl, len(jcfg.block_pattern))
    assert nb == jd[3]
    # c is the middle cores' contraction: f32 sums in another order
    for got, want in ((dpl["c"], jd[2]["c"]), (dbc["g1"], jd[1]["g1"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    got = dbase["blocks"][0]["mixer"]["wq"]
    want = jd[0]["blocks"][0]["mixer"]["wq"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert dbase["embed"]["tok"] is tp["base"]["embed"]["tok"]


def test_column_penalty_masks_compose_autoregressively():
    base = torch.zeros((1, 6), dtype=torch.bool)
    base[0, 1] = True
    draft = torch.tensor([[3, 3, 5]])
    masks = tspec.column_penalty_masks(base, draft, 6)
    assert masks.shape == (1, 4, 6)
    assert masks[0, 0].tolist() == base[0].tolist()
    assert bool(masks[0, 1, 3]) and not bool(masks[0, 1, 5])
    assert bool(masks[0, 3, 3]) and bool(masks[0, 3, 5])
    assert tspec.column_penalty_masks(None, draft, 6) is None
    want = jspec.column_penalty_masks(jnp.asarray(base.numpy()),
                                      jnp.asarray(draft.numpy()), 6)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(want))


def test_spec_config_validates():
    with pytest.raises(ValueError):
        ServeConfig(cache_len=3, spec=SpecConfig(spec_k=3)).validate()
    with pytest.raises(ValueError):
        SpecConfig(spec_k=1, draft_layer_stride=0).validate()
    assert ServeConfig(spec=SpecConfig(spec_k=2)).validate().spec.enabled
