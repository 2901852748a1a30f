"""The port's model against the JAX model on the smoke stablelm config.

f32 weights made by the JAX package and carried across with
``convert.from_jax_numpy``; a 4+1d MetaTT adapter over 3 tasks from
``random_tt(scale=0.5)``. The port's ``forward`` and ``decode_step`` (its
kernel wrappers run their plain versions on the CPU) are held against
``repro.models.transformer`` under both the JAX reference path
(``policy=None``) and its Pallas kernels in interpret mode
(``dispatch.PALLAS_INTERPRET``). Tolerance 1e-5 (f32, the same algorithm
with sums in another order), relative to the largest logit.
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
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import transformer as JT
from repro.peft import api as jpeft

from repro_torch import configs as tconfigs
from repro_torch.config.base import RunConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core import metatt as tmetatt
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.peft import api as tpeft

KEY = jax.random.PRNGKey(3)
TOL = 1e-5
POLICIES = {"ref": None, "pallas_interpret": jdispatch.PALLAS_INTERPRET}


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jconfigs.get_smoke_config("stablelm-1.6b")
    jspec = JM.build_adapter_spec(JRunConfig(
        model=jcfg, shape=SHAPES["decode_32k"], adapter_kind="metatt",
        adapter_variant="4+1d", num_tasks=3, adapter_rank=8))
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 8,
                                            scale=0.5)}
    cfg = tconfigs.get_smoke_config("stablelm-1.6b")
    spec = TM.build_adapter_spec(RunConfig(
        model=cfg, adapter_kind="metatt", adapter_variant="4+1d",
        num_tasks=3, adapter_rank=8))
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11))
    return jcfg, jspec, jp, cfg, spec, tp, tokens


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_config_and_spec_match_the_jax_package():
    jcfg, jspec, _, cfg, spec, _, _ = _setup()
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "padded_vocab", "resolved_head_dim",
              "num_super_blocks", "norm_eps", "rope_theta", "mlp"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full_j = jconfigs.get_config("stablelm-1.6b")
    full_t = tconfigs.get_config("stablelm-1.6b")
    assert (full_t.num_layers, full_t.d_model, full_t.d_ff,
            full_t.padded_vocab) == (full_j.num_layers, full_j.d_model,
                                     full_j.d_ff, full_j.padded_vocab)
    assert spec.cfg.mode_sizes == jspec.cfg.mode_sizes
    assert spec.cfg.matrix_types == jspec.cfg.matrix_types
    assert spec.cfg.alpha == jspec.cfg.alpha


def test_metatt_factors_and_deltas_match():
    _, jspec, jp, _, spec, tp, _ = _setup()
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], {})
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], {})
    assert _rel(pl["c"], jpl["c"]) < TOL
    x = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    task = np.array([2, 0, 1])
    for m in ("attn_q", "attn_v"):
        jd = jpeft.adapter_delta(jspec, jbc, {"c": jpl["c"][1]}, x, m,
                                 task=jnp.asarray(task))
        td = tpeft.adapter_delta(spec, bc, {"c": pl["c"][1]},
                                 torch.from_numpy(x), m,
                                 task=torch.from_numpy(task))
        assert _rel(td, jd) < TOL
        ja, jb, jalpha = jpeft.lora_form_factors(
            jspec, jbc, {"c": jpl["c"][1]}, m, task=jnp.asarray(task))
        ta, tb, talpha = tpeft.lora_form_factors(
            spec, bc, {"c": pl["c"][1]}, m, task=torch.from_numpy(task))
        assert ta.shape == ja.shape and talpha == jalpha
        assert _rel(ta, ja) < TOL and _rel(tb, jb) < TOL
    # ΔW == 0 at init (zero first core)
    zero = tmetatt.init_params(spec.cfg, device="cpu")
    assert float(tmetatt.materialize_delta(zero, spec.cfg, 0, "attn_q",
                                           task=1).abs().max()) == 0.0


def test_norm_and_rope_match():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.array([[3], [9]])
    assert _rel(tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
                jlayers.rmsnorm(x, w)) < TOL
    assert _rel(tlayers.apply_rope(torch.from_numpy(x[:, :1]),
                                   torch.from_numpy(pos), 10000.0),
                jlayers.apply_rope(x[:, :1], pos, 10000.0)) < TOL
    assert _rel(tlayers.apply_rope(torch.from_numpy(x),
                                   torch.arange(5), 10000.0),
                jlayers.apply_rope(x, jnp.arange(5), 10000.0)) < TOL


def test_layernorm_and_ffn_kinds_match():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    assert _rel(tlayers.layernorm(*map(torch.from_numpy, (x, w, b))),
                jlayers.layernorm(x, w, b)) < TOL
    ws = {k: (rng.standard_normal(shape) / 4).astype(np.float32)
          for k, shape in (("wg", (16, 24)), ("wu", (16, 24)),
                           ("wd", (24, 16)))}
    tws = {k: torch.from_numpy(v) for k, v in ws.items()}
    for kind in ("swiglu", "geglu", "gelu"):
        assert _rel(tlayers.dense_ffn(torch.from_numpy(x), tws,
                                      tlayers.NO_ADAPTER, kind),
                    jlayers.dense_ffn(x, ws, jlayers.NO_ADAPTER, kind)) < TOL


@pytest.mark.parametrize("policy,tpolicy,task", [
    ("ref", "default", "scalar"), ("pallas_interpret", "default", "scalar"),
    ("ref", "ref", "scalar"), ("pallas_interpret", "ref", "scalar"),
    ("ref", "default", "vector")])
def test_forward_logits_and_caches_match(policy, tpolicy, task):
    """A scalar task routes the fused linear (K1's form); a (B,) task
    vector over T > 1 tokens takes the batched einsum in both packages,
    held against the JAX reference path (under the Pallas policy JAX also
    swaps softmax for tiled flash, which is what the scalar cases check)."""
    jcfg, jspec, jp, cfg, spec, tp, tokens = _setup()
    jtask, ttask = ((jnp.int32(1), 1) if task == "scalar"
                    else (jnp.array([2, 0]), torch.tensor([2, 0])))
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], {})
    want = JT.forward(jp["base"], jcfg, jspec, jbc, jpl, jnp.asarray(tokens),
                      task=jtask, policy=POLICIES[policy])
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], {})
    got = TT.forward(tp["base"], cfg, spec, bc, pl, tokens, task=ttask,
                     policy=tdispatch.REF if tpolicy == "ref" else None,
                     return_caches=True, device="cpu")
    assert got.logits.shape == want.logits.shape
    assert _rel(got.logits, want.logits) < TOL
    for gc, wc in zip(got.caches, want.caches):
        for name in ("k", "v"):
            assert tuple(gc["self"][name].shape) == wc["self"][name].shape
            assert _rel(gc["self"][name], wc["self"][name]) < TOL


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("task_kind", ["scalar", "vector"])
def test_decode_step_matches(policy, task_kind):
    jcfg, jspec, jp, cfg, spec, tp, tokens = _setup()
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], {})
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], {})
    s_len = 16
    pre = JT.forward(jp["base"], jcfg, jspec, jbc, jpl, jnp.asarray(tokens),
                     task=jnp.int32(0))
    jcaches = jax.tree_util.tree_map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, s_len - c.shape[2]),
                              (0, 0), (0, 0))), pre.caches)
    tcaches = from_jax_numpy(jax.device_get(jcaches), device="cpu")
    pos = np.array([11, 4], np.int32)            # per-slot positions
    tok = np.array([[5], [77]])
    jtask = jnp.int32(2) if task_kind == "scalar" else jnp.array([2, 0])
    ttask = 2 if task_kind == "scalar" else torch.tensor([2, 0])
    want, jnew = JT.decode_step(jp["base"], jcfg, jspec, jbc, jpl,
                                jnp.asarray(tok), jcaches, jnp.asarray(pos),
                                task=jtask, policy=POLICIES[policy])
    got, tnew = TT.decode_step(tp["base"], cfg, spec, bc, pl, tok, tcaches,
                               torch.from_numpy(pos), task=ttask,
                               device="cpu")
    assert got.shape == want.shape
    assert _rel(got, want) < TOL
    for gc, wc in zip(tnew, jnew):      # the in-place cache write
        assert _rel(gc["self"]["k"], wc["self"]["k"]) < TOL


def test_base_init_distributions():
    cfg = tconfigs.get_smoke_config("stablelm-1.6b")
    g = torch.Generator().manual_seed(0)
    p = TT.init_base_params(cfg, g, device="cpu")
    emb = p["embed"]["tok"]
    assert emb.shape == (cfg.padded_vocab, cfg.d_model)
    assert abs(float(emb.std()) - 0.02) < 2e-3
    wq = p["blocks"][0]["mixer"]["wq"]
    assert wq.shape == (cfg.num_super_blocks, cfg.d_model, cfg.q_dim)
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.01
    assert float(p["blocks"][0]["norm1"]["w"].abs().max()) == 0.0
