"""granite-34b (MQA) and mistral-large-123b in the port against the JAX
package.

Both are dense attention decoders at head_dim 128 whose GQA groups lie
outside {1, 2, 4, 8}: granite-34b has 48 query heads over one KV head
(a gelu MLP), mistral-large 96 over 8 (G = 12, SwiGLU). On the card they
are served through the any-group instances of K4, #8 and #8q
(``chip_smoke.py`` phase 14); here the CPU tensors run their plain
versions. The full configs equal the JAX ones field for field, with equal
parameter counts (counted on the meta device and through
``jax.eval_shape``: nothing of full width is allocated). On each smoke
config and on variants of it with G = 12 (24 heads of 16 over 2) and
G = 48 (48 heads of 8 over 1) — q_dim 384 != d_model 64, and the v
projection (16 or 8 wide) far narrower than q's — with weights made by
the JAX package (its PRNG) and a 4+1d MetaTT q/v adapter over 3 tasks
(``random_tt(scale=0.3)``: at 0.5 these 4-layer models are so
ill-conditioned that the JAX package's own reference and interpret legs
differ by 1.8e-5) carried across with
``repro_torch.convert.from_jax_numpy``:

* prefill and decode logits and caches within 1e-5 (f32, relative to the
  largest value) of the JAX model's, under its reference path and its
  Pallas kernels in interpret mode;
* (``tests/test_torch_gqa_engines.py``, over the same setups) the port's
  dense, paged (shared prefix, cold then warm) and int8-KV paged engines
  give greedy tokens IDENTICAL to the JAX engines', with equal counters;
* token-by-token decode equals the parallel forward within 1e-5 (the
  case of ``tests/test_serving.py::test_decode_matches_parallel_forward``,
  whose bf16-tolerant limit is 2e-2), and
  on the smoke configs the MetaTT loss is within 1e-5 of ``JM.loss_fn``
  with a non-zero adapter gradient (``tests/test_models_smoke.py``).
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
from repro.models import transformer as JT
from repro.peft import api as jpeft
from repro.serving import AdapterRuntime as JRuntime

from repro_torch import configs as tconfigs
from repro_torch.config.base import RunConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.peft import api as tpeft
from repro_torch.serving import AdapterRuntime, Engine

ARCHS = ["granite-34b", "mistral-large-123b"]
KEY = jax.random.PRNGKey(27)
TOL = 1e-5
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
POLICIES = {"ref": None, "pallas_interpret": jdispatch.PALLAS_INTERPRET}
#: the smoke config as it is, and with G = 12 and G = 48 (heads, kv
#: heads, head_dim)
VARIANTS = {"smoke": {}, "g12": dict(num_heads=24, num_kv_heads=2,
                                     head_dim=16),
            "g48": dict(num_heads=48, num_kv_heads=1, head_dim=8)}
#: (layers, d_model, heads, kv heads, head_dim, d_ff, vocab, mlp) at full
#: width, and the base parameter count (JAX ``init_base_params``)
FULL = {"granite-34b": ((88, 6144, 48, 1, 128, 24576, 49152, "gelu"),
                        33_660_377_088),
        "mistral-large-123b": ((88, 12288, 96, 8, 128, 28672, 32768,
                                "swiglu"), 122_207_416_320)}
CASES = [(a, v) for a in ARCHS for v in VARIANTS]
#: the served adapter's ``random_tt`` scale (see the module docstring)
SCALE = 0.3


def _rel(got, want) -> float:
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _runs(cfg, jcfg, rank=4, variant="4+1d"):
    common = dict(adapter_kind="metatt", adapter_variant=variant,
                  num_tasks=3, adapter_rank=rank)
    if variant != "4+1d":
        common.pop("num_tasks")
    return (JRunConfig(model=jcfg, shape=SHAPES["decode_32k"], **common),
            RunConfig(model=cfg, **common))


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
    assert (cfg.q_dim, cfg.kv_dim) == (jcfg.q_dim, jcfg.kv_dim)
    if not smoke:
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
                cfg.vocab_size, cfg.mlp) == FULL[arch][0]
        assert cfg.param_dtype == torch.bfloat16
        assert cfg.num_heads // cfg.num_kv_heads not in (1, 2, 4, 8)
    TT.check_supported(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_counts_match_jax(arch):
    """The base and the 4+1d adapter's parameters, counted from shapes
    alone in both packages (the v adapter's output slice is the KV
    width: 128 at granite, 1024 at mistral)."""
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    jrun, trun = _runs(cfg, jcfg, rank=8)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    assert spec.cfg.mode_sizes == jspec.cfg.mode_sizes
    assert tuple(spec.cfg.d_out) == (cfg.q_dim, cfg.kv_dim)
    got = TM.count_params(TM.init_params(cfg, spec, device="meta"))
    want = JM.count_params(jax.eval_shape(
        lambda: JM.init_params(jcfg, jspec, KEY)))
    assert got == want
    assert got["base"] == FULL[arch][1]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_a_layer_at_a_time_with_the_same_numbers(arch):
    """The base init draws each stacked linear one super-block at a time
    (a whole-stack f32 draw of granite-34b's (88, 6144, 24576)
    up-projection would be 53 GB); on the CPU the numbers equal one draw
    of the whole stack, cast once."""
    cfg = tconfigs.get_smoke_config(arch)
    d, ff, nb = cfg.d_model, cfg.d_ff, 3
    got = TT._linear_init(torch.Generator().manual_seed(5), d, ff, nb,
                          torch.bfloat16, "cpu")
    want = (torch.randn((nb, d, ff), generator=torch.Generator()
                        .manual_seed(5)) / d ** 0.5).to(torch.bfloat16)
    assert got.shape == (nb, d, ff) and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the smoke models against the JAX models, at G = smoke, 12 and 48
# ---------------------------------------------------------------------------


def _configs(arch, variant):
    over = VARIANTS[variant]
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **over),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **over))


@functools.lru_cache(maxsize=None)
def _setup(arch, variant):
    """``arch``'s smoke config (``variant``: its group changed) in both
    packages, 4+1d MetaTT on q/v over 3 tasks at rank 4
    (``random_tt(scale=SCALE)``), made by the JAX package; the JAX and port
    runtimes over the same weights."""
    jcfg, cfg = _configs(arch, variant)
    jrun, trun = _runs(cfg, jcfg)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=SCALE)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    trt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                               tp["frozen"])
    return jcfg, jspec, jp, jrt, cfg, spec, tp, trt


@pytest.mark.parametrize("jpolicy", sorted(POLICIES))
@pytest.mark.parametrize("arch,variant", CASES)
def test_prefill_logits_and_caches_match_jax(arch, variant, jpolicy):
    jcfg, jspec, jp, _, cfg, spec, tp, _ = _setup(arch, variant)
    if variant != "smoke":
        assert cfg.q_dim != cfg.d_model and cfg.kv_dim < cfg.q_dim
        assert cfg.num_heads // cfg.num_kv_heads == int(variant[1:])
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
            assert gc["self"][name].shape[-2] == cfg.num_kv_heads
            assert _rel(gc["self"][name], wc["self"][name]) < TOL


@pytest.mark.parametrize("jpolicy", sorted(POLICIES))
@pytest.mark.parametrize("arch,variant", CASES)
def test_decode_step_logits_and_caches_match_jax(arch, variant, jpolicy):
    """One decode step of 2 slots at their own positions and tasks from
    the same prefilled caches: logits and the written caches."""
    jcfg, jspec, jp, _, cfg, spec, tp, _ = _setup(arch, variant)
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


@pytest.mark.parametrize("arch,variant", CASES)
def test_decode_matches_parallel_forward(arch, variant):
    """Token-by-token decode over 8 positions equals the parallel forward
    within 1e-5 in f32 (the JAX package's case, whose limit is 2e-2)."""
    _, _, _, _, cfg, spec, tp, _ = _setup(arch, variant)
    bc, pl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    b_, s_ = 2, 8
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b_, s_)))
    out = TT.forward(tp["base"], cfg, spec, bc, pl, tokens, task=2,
                     device="cpu")
    caches = TT.init_caches(cfg, b_, s_, torch.float32, device="cpu")
    steps = []
    for t in range(s_):
        lg, caches = TT.decode_step(tp["base"], cfg, spec, bc, pl,
                                    tokens[:, t:t + 1], caches,
                                    torch.full((b_,), t),
                                    task=torch.full((b_,), 2), device="cpu")
        steps.append(lg)
    dec = torch.stack(steps, 1)
    rel = float((dec - out.logits).abs().max() / out.logits.abs().max())
    assert rel < TOL, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_matches_jax_and_the_adapter_gets_a_gradient(arch):
    """The smoke config's MetaTT-4d q/v loss (``tests/test_models_smoke.py``
    runs a forward and a train step for every arch): within 1e-5 of the
    JAX ``loss_fn`` on the same weights, with a non-zero gradient on
    every core."""
    jcfg, cfg = _configs(arch, "smoke")
    jrun, trun = _runs(cfg, jcfg, variant="4d")
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.2)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    jl, _ = JM.loss_fn(jp["adapter"], jp["base"], jp["frozen"],
                       {"tokens": jnp.asarray(tokens)}, jcfg, jspec)
    adapter = {"cores": [c.clone().requires_grad_(True)
                         for c in tp["adapter"]["cores"]]}
    loss, _ = TM.loss_fn(adapter, tp["base"], tp["frozen"],
                         {"tokens": torch.from_numpy(tokens)}, cfg, spec,
                         device="cpu")
    assert np.isfinite(float(loss.detach())) and float(loss.detach()) > 0
    assert abs(float(loss.detach()) - float(jl)) <= TOL * abs(float(jl))
    grads = torch.autograd.grad(loss, TM.tensors(adapter))
    assert all(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_cuda(arch):
    """The model's init and the engine run on the CUDA device unless the
    caller asks for the CPU: without a card they raise rather than fall
    back."""
    _, _, _, _, cfg, spec, _, trt = _setup(arch, "smoke")
    if torch.cuda.is_available():
        assert Engine(cfg, trt).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(cfg, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, trt)
    assert Engine(cfg, trt, device="cpu").device.type == "cpu"
