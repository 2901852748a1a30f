"""The Mamba mixer and jamba-v0.1-52b in the port against the JAX package
(f32, on the CPU).

jamba's super-block is 7 mamba layers and one attention layer, with a
MoE FFN (16 experts, top-2) on every second layer; on the card it is
prefilled, decoded and trained at full width (``chip_smoke.py`` phase 19).
The mixer (``models/mamba.py``) is torch ops between two K1 projections,
as the JAX mixer is XLA between two ``adapted_linear`` calls. Here, with
weights made by the JAX package (its PRNG) and carried across with
``repro_torch.convert.from_jax_numpy`` (the f32 ``a_log`` / ``d`` leaves
too), and inputs made with numpy:

* the mixer within 1e-5 (relative to the largest value) of the JAX mixer
  on both prefill branches — the whole-sequence scan (T = 8 at the
  default chunk of 256) and the chunked scan (T = 2 · chunk and
  T = 3 · chunk at chunk 4) — with its last state; its input and
  weight gradients within 1e-4 of ``jax.vjp``'s on the chunked branch;
  the decode step from a random state within 1e-5;
* prefill then decode: the port's prefill cache holds the last K - 1
  in-projection rows, so decoding from it equals the parallel forward
  (1e-5); the JAX prefill stores the rows after the conv and SiLU there,
  and its own prefill-then-decode misses its parallel forward (asserted,
  to show why the port differs);
* the jamba smoke config and the full config field by field (and against
  ``tests/test_models_smoke.py``'s assigned values), the full-width
  parameter counts on the meta device against ``jax.eval_shape``;
* the smoke model's forward logits (1e-5), token-by-token decode against
  the parallel forward and prefill then decode (1e-5), the MetaTT-4d loss
  (attn q / v, ``mamba_in`` / ``mamba_out``; 1e-5) and its gradients
  (1e-4) under the JAX reference path, plain and with remat (the
  attention layer's kernels are held to the Pallas ones elsewhere);
* the ``mamba_in`` / ``mamba_out`` folds against the JAX merge (1e-5);
* the engine refuses the model with the JAX engine's error before it
  touches a weight, and the paged pools refuse mamba positions.

The adapter is ``random_tt(0.1)``: eight layers of the smoke model
magnify f32 rounding, and at 0.3 the JAX package's own reference and
Pallas-interpret forwards differ by 1.6e-5 of the largest logit (2.5e-6
at 0.1).
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
from repro.core import merge as jmerge
from repro.core import tt as jtt
from repro.kernels import dispatch as jdispatch
from repro.models import mamba as jmamba
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.layers import AdapterCtx as JCtx
from repro.peft import api as jpeft

from repro_torch import configs as tconfigs
from repro_torch.config.base import RunConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core import merge as tmerge
from repro_torch.models import mamba as tmamba
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.layers import AdapterCtx
from repro_torch.peft import api as tpeft
from repro_torch.serving import AdapterRuntime, Engine

ARCH = "jamba-v0.1-52b"
KEY = jax.random.PRNGKey(31)
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
POLICIES = {"ref": None, "pallas_interpret": jdispatch.PALLAS_INTERPRET}
#: the base parameters of full-width jamba-v0.1-52b (JAX init_base_params)
JAMBA_PARAMS = 51_301_879_808
#: the adapter's ``random_tt`` scale (see the module docstring)
SCALE = 0.1


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _fro(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _runs(cfg, jcfg, **kw):
    common = dict(adapter_kind="metatt", adapter_variant="4d",
                  adapter_rank=4, **kw)
    return (JRunConfig(model=jcfg, shape=SHAPES["train_4k"], **common),
            RunConfig(model=cfg, **common))


@functools.lru_cache(maxsize=None)
def _setup():
    """jamba's smoke config in both packages with a MetaTT-4d adapter of
    rank 4 on its default matrices (``random_tt(SCALE)``), made by the JAX
    package. Returns (jcfg, jspec, jp, cfg, spec, tp)."""
    jcfg, cfg = (jconfigs.get_smoke_config(ARCH),
                 tconfigs.get_smoke_config(ARCH))
    jrun, trun = _runs(cfg, jcfg)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = jax.jit(JM.init_params, static_argnums=(0, 1))(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=SCALE)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jspec, jp, cfg, spec, tp


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mixer_args():
    """Layer 0's mamba weights and adapter slice in both packages:
    (jw, jctx, tw, tctx)."""
    jcfg, jspec, jp, cfg, spec, tp = _setup()
    assert jcfg.block_pattern[0][0] == "mamba"
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    tbc, tpl = tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])
    jw = jax.tree_util.tree_map(lambda a: a[0], jp["base"]["blocks"][0]
                                ["mixer"])
    tw = TT._at(tp["base"]["blocks"][0]["mixer"], 0)
    jctx = JCtx(jspec, jbc, jax.tree_util.tree_map(lambda a: a[0], jpl))
    tctx = AdapterCtx(spec, tbc, TT._at(tpl, 0))
    return jw, jctx, tw, tctx


def _x(cfg, b, t, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_mixer(t, chunk):
    jcfg = _setup()[0]
    jw, jctx, _, _ = _mixer_args()
    x = _x(jcfg, 2, t)
    fn = jax.jit(lambda x_: jmamba.mamba_mixer(x_, jw, jctx, jcfg,
                                               chunk=chunk))
    y, cache = fn(jnp.asarray(x))
    return x, np.asarray(y), jax.tree_util.tree_map(np.asarray, cache)


#: (T, chunk): the whole-sequence branch (t <= chunk), then the chunked
#: one (t % chunk == 0 and t > chunk) over two and three chunks
MIXER_CASES = [(8, 256), (8, 4), (12, 4)]


@pytest.mark.parametrize("t,chunk", MIXER_CASES,
                         ids=["whole-T8", "chunked-T8c4", "chunked-T12c4"])
def test_mixer_matches_jax_on_both_prefill_branches(t, chunk):
    cfg = _setup()[3]
    x, jy, jcache = _jax_mixer(t, chunk)
    _, _, tw, tctx = _mixer_args()
    with torch.no_grad():
        y, cache = tmamba.mamba_mixer(torch.from_numpy(x), tw, tctx, cfg,
                                      chunk=chunk)
    assert _rel(y, jy) <= 1e-5
    assert _rel(cache["h"], jcache["h"]) <= 1e-5
    assert cache["h"].dtype == torch.float32
    # the port's conv window: the last K - 1 in-projection rows
    with torch.no_grad():
        xi = (torch.from_numpy(x) @ tw["w_in"])[..., :cfg.mamba_d_inner]
        d = tpeft.adapter_delta(tctx.spec, tctx.broadcast, tctx.layer,
                                torch.from_numpy(x), "mamba_in")
        xi = xi + d[..., :cfg.mamba_d_inner]
    k = cfg.mamba_conv
    torch.testing.assert_close(cache["conv"], xi[:, -(k - 1):], rtol=1e-5,
                               atol=1e-5)


def test_mixer_gradients_match_jax_vjp_on_the_chunked_branch():
    """The scan's backward (the reverse recurrence, ``_LinearScan``) and
    the per-chunk checkpoints: d(x) and every weight's gradient within
    1e-4 (relative Frobenius) of ``jax.vjp``'s, T = 12 in chunks of 4."""
    jcfg, _, _, cfg, _, _ = _setup()
    jw, jctx, tw, tctx = _mixer_args()
    x = _x(jcfg, 2, 12, seed=3)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)
    names = sorted(jw)

    def jfn(x_, *ws):
        y, _ = jmamba.mamba_mixer(x_, dict(zip(names, ws)), jctx, jcfg,
                                  chunk=4)
        return y

    @jax.jit
    def jvjp(x_, ws, c):
        return jax.vjp(jfn, x_, *ws)[1](c)
    jgrads = jvjp(jnp.asarray(x), [jw[n] for n in names], jnp.asarray(cot))
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        tw[n].clone().requires_grad_(True) for n in names]
    y, _ = tmamba.mamba_mixer(leaves[0], dict(zip(names, leaves[1:])), tctx,
                              cfg, chunk=4)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(cot))
    for name, g, want in zip(["x"] + names, grads, jgrads):
        assert _fro(g, want) <= 1e-4, name


def test_mixer_decode_step_matches_jax():
    """One decode step from a random state and conv window, in place."""
    jcfg, _, _, cfg, _, _ = _setup()
    jw, jctx, tw, tctx = _mixer_args()
    rng = np.random.default_rng(5)
    di, k = cfg.mamba_d_inner, cfg.mamba_conv
    h = rng.standard_normal((2, di, cfg.mamba_d_state)).astype(np.float32)
    conv = rng.standard_normal((2, k - 1, di)).astype(np.float32)
    x = _x(jcfg, 2, 1, seed=6)
    jy, jc = jax.jit(lambda x_, c_: jmamba.mamba_mixer(
        x_, jw, jctx, jcfg, cache=c_))(jnp.asarray(x),
                                        {"h": jnp.asarray(h),
                                         "conv": jnp.asarray(conv)})
    cache = {"h": torch.from_numpy(h.copy()),
             "conv": torch.from_numpy(conv.copy())}
    with torch.no_grad():
        y, out = tmamba.mamba_mixer(torch.from_numpy(x), tw, tctx, cfg,
                                    cache=cache)
    assert out is cache      # updated in place
    assert _rel(y, jy) <= 1e-5
    assert _rel(cache["h"], jc["h"]) <= 1e-5
    assert _rel(cache["conv"], jc["conv"]) <= 1e-5


def test_mixer_prefill_then_decode_equals_the_parallel_forward():
    """Prefill 5 tokens, decode 3 from the prefill's cache: the port's
    outputs equal its parallel mixer (and the JAX one) over the 8
    tokens; the JAX prefill's conv window (rows after the conv and SiLU)
    makes its own decode miss that limit."""
    jcfg, _, _, cfg, _, _ = _setup()
    jw, jctx, tw, tctx = _mixer_args()
    x, jy, _ = _jax_mixer(8, 256)
    p = 5
    with torch.no_grad():
        _, cache = tmamba.mamba_mixer(torch.from_numpy(x[:, :p]), tw, tctx,
                                      cfg)
        steps = [tmamba.mamba_mixer(torch.from_numpy(x[:, i:i + 1]), tw,
                                    tctx, cfg, cache=cache)[0]
                 for i in range(p, 8)]
    assert _rel(torch.cat(steps, 1), jy[:, p:]) <= 1e-5
    jstep = jax.jit(lambda x_: jmamba.mamba_mixer(
        x_[:, p:p + 1], jw, jctx, jcfg, cache=jmamba.mamba_mixer(
            x_[:, :p], jw, jctx, jcfg)[1])[0])(jnp.asarray(x))
    assert _rel(np.asarray(jstep), jy[:, p:p + 1]) > 1e-2


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_matches_jax_field_by_field(smoke):
    get = "get_smoke_config" if smoke else "get_config"
    cfg, jcfg = getattr(tconfigs, get)(ARCH), getattr(jconfigs, get)(ARCH)
    assert ARCH in tconfigs.ALL_IDS
    for f in dataclasses.fields(jcfg):
        want = getattr(jcfg, f.name)
        assert getattr(cfg, f.name) == DTYPES.get(want, want), f.name
    assert (cfg.mamba_d_inner, cfg.resolved_dt_rank) == (
        jcfg.mamba_d_inner, jcfg.resolved_dt_rank)
    assert cfg.padded_vocab == jcfg.padded_vocab
    TT.check_supported(cfg)
    if not smoke:   # tests/test_models_smoke.py's assigned values
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size, cfg.num_experts,
                cfg.experts_per_token) == (32, 4096, 32, 8, 14336, 65536, 16,
                                           2)
        assert (cfg.mamba_d_inner, cfg.resolved_dt_rank, cfg.mamba_d_state,
                cfg.mamba_conv, cfg.num_super_blocks) == (8192, 256, 16, 4,
                                                          4)
    spec = TM.build_adapter_spec(RunConfig(model=cfg))
    jspec = JM.build_adapter_spec(JRunConfig(model=jcfg,
                                             shape=SHAPES["train_4k"]))
    assert spec.cfg.matrix_types == jspec.cfg.matrix_types == (
        "attn_q", "attn_v", "mamba_in", "mamba_out")
    assert TM.matrix_dims(cfg) == JM.matrix_dims(jcfg)
    assert spec.cfg.mode_sizes == jspec.cfg.mode_sizes


def test_full_width_parameter_counts_match_jax():
    """Base and 4d adapter parameters from shapes alone in both packages:
    51,301,879,808 base parameters (f32 a_log / d and routers)."""
    cfg, jcfg = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    jrun, trun = _runs(cfg, jcfg, adapter_alpha=4.0)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    got = TM.count_params(TM.init_params(cfg, spec, device="meta"))
    want = JM.count_params(jax.eval_shape(
        lambda: JM.init_params(jcfg, jspec, KEY)))
    assert got == want
    assert got["base"] == JAMBA_PARAMS


def test_converted_weights_keep_their_dtypes_and_layout():
    """``from_jax_numpy`` on the jamba tree: every leaf's shape and dtype
    (a_log and d f32) equal the port's own init of the same config."""
    jcfg, jspec, jp, cfg, spec, tp = _setup()
    own = TM.init_params(cfg, spec, torch.Generator().manual_seed(0),
                         device="cpu")["base"]

    def paths(tree, pre=""):
        if isinstance(tree, dict):
            return {k: v for n, t in tree.items()
                    for k, v in paths(t, f"{pre}/{n}").items()}
        if isinstance(tree, (list, tuple)):
            return {k: v for n, t in enumerate(tree)
                    for k, v in paths(t, f"{pre}/{n}").items()}
        return {pre: (tuple(tree.shape), tree.dtype)}
    assert paths(tp["base"]) == paths(own)
    mix = tp["base"]["blocks"][0]["mixer"]
    assert mix["a_log"].dtype == mix["d"].dtype == torch.float32
    np.testing.assert_array_equal(
        mix["a_log"].numpy(), np.asarray(jp["base"]["blocks"][0]["mixer"]
                                         ["a_log"]))


# ---------------------------------------------------------------------------
# the smoke model
# ---------------------------------------------------------------------------


B, S, P = 2, 8, 5     # batch, sequence, prompt of the prefill-then-decode


@functools.lru_cache(maxsize=None)
def _jax_forward():
    jcfg, jspec, jp, cfg, _, _ = _setup()
    bc, pl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    toks = _tokens(cfg, B, S)
    out = jax.jit(lambda t: JT.forward(jp["base"], jcfg, jspec, bc, pl,
                                       t).logits)(jnp.asarray(toks))
    return toks, np.asarray(out)


def _factors():
    _, _, _, cfg, spec, tp = _setup()
    return tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])


def test_forward_logits_match_jax():
    _, _, _, cfg, spec, tp = _setup()
    toks, want = _jax_forward()
    bc, pl = _factors()
    with torch.no_grad():
        out = TT.forward(tp["base"], cfg, spec, bc, pl, toks, device="cpu",
                         return_caches=True)
    assert _rel(out.logits, want) <= 1e-5
    kinds = [next(iter(c)) for c in out.caches]
    assert kinds == ["ssm", "ssm", "ssm", "ssm", "self", "ssm", "ssm", "ssm"]
    nb, di = cfg.num_super_blocks, cfg.mamba_d_inner
    assert out.caches[0]["ssm"]["h"].shape == (nb, B, di,
                                               cfg.mamba_d_state)
    assert out.caches[0]["ssm"]["conv"].shape == (nb, B, cfg.mamba_conv - 1,
                                                  di)


def test_decode_matches_parallel_forward():
    """Token-by-token decode from zero caches against the parallel forward
    (the case of tests/test_serving.py::test_decode_matches_parallel_forward,
    held at 1e-5)."""
    _, _, _, cfg, spec, tp = _setup()
    toks, want = _jax_forward()
    bc, pl = _factors()
    caches = TT.init_caches(cfg, B, S, torch.float32, device="cpu")
    assert [next(iter(c)) for c in caches][3:6] == ["ssm", "self", "ssm"]
    with torch.no_grad():
        steps = [TT.decode_step(tp["base"], cfg, spec, bc, pl,
                                toks[:, t:t + 1], caches, t,
                                device="cpu")[0] for t in range(S)]
    assert _rel(torch.stack(steps, 1), want) <= 1e-5


def test_prefill_then_decode_matches_the_parallel_forward():
    """A prefill of P tokens (its k/v placed in caches of S cells, its
    mamba states and conv windows as they are), then S - P decode steps:
    the logits of every position equal the JAX parallel forward's."""
    _, _, _, cfg, spec, tp = _setup()
    toks, want = _jax_forward()
    bc, pl = _factors()
    with torch.no_grad():
        out = TT.forward(tp["base"], cfg, spec, bc, pl, toks[:, :P],
                         device="cpu", return_caches=True)
        caches = TT.init_caches(cfg, B, S, torch.float32, device="cpu")
        for dst, src in zip(caches, out.caches):
            for kind, leaves in src.items():
                for name, t in leaves.items():
                    if kind == "self":
                        dst[kind][name][:, :, :P] = t
                    else:
                        dst[kind][name].copy_(t)
        steps = [TT.decode_step(tp["base"], cfg, spec, bc, pl,
                                toks[:, t:t + 1], caches, t,
                                device="cpu")[0] for t in range(P, S)]
    assert _rel(out.logits, want[:, :P]) <= 1e-5
    assert _rel(torch.stack(steps, 1), want[:, P:]) <= 1e-5


@functools.lru_cache(maxsize=None)
def _jax_grads(jpolicy):
    jcfg, jspec, jp, cfg, _, _ = _setup()
    rng = np.random.default_rng(7)
    toks = _tokens(cfg, 3, 13, seed=8)
    mask = (rng.random((3, 13)) > 0.2).astype(np.float32)
    loss_fn = functools.partial(JM.loss_fn, policy=POLICIES[jpolicy])
    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                          static_argnums=(4, 5))(
        jp["adapter"], jp["base"], jp["frozen"],
        {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}, jcfg,
        jspec)
    return toks, mask, float(jl), jax.tree_util.tree_leaves(jg)


@pytest.mark.parametrize("jpolicy,remat", [("ref", False), ("ref", True)],
                         ids=["ref-plain", "ref-remat"])
def test_loss_and_adapter_grads_match_jax(jpolicy, remat):
    _, _, _, cfg, spec, tp = _setup()
    toks, mask, jl, jleaves = _jax_grads(jpolicy)
    adapter = {"cores": [c.clone().requires_grad_(True)
                         for c in tp["adapter"]["cores"]]}
    loss, _ = TM.loss_fn(adapter, tp["base"], tp["frozen"],
                         {"tokens": torch.from_numpy(toks),
                          "mask": torch.from_numpy(mask)}, cfg, spec,
                         remat=remat, device="cpu")
    assert abs(float(loss.detach()) - jl) <= 1e-5 * abs(jl)
    grads = torch.autograd.grad(loss, TM.tensors(adapter))
    assert len(grads) == len(jleaves) == 4
    for g, want in zip(grads, jleaves):
        assert float(np.abs(np.asarray(want)).max()) > 0
        assert _fro(g, want) <= 1e-4


def test_mamba_folds_match_jax():
    """``fold_transformer`` of the 4d adapter on jamba: ``mamba_in`` /
    ``mamba_out`` of every mamba position folded as JAX folds them
    (1e-5), the attention q / v too, and nothing else changed."""
    jcfg, jspec, jp, cfg, spec, tp = _setup()
    want = jmerge.fold_transformer(jp["adapter"], jspec.cfg, jp["base"],
                                   jcfg)
    got = tmerge.fold_transformer(tp["adapter"], spec.cfg, tp["base"], cfg)
    jl = jax.tree_util.tree_leaves(want)
    tl = TM.tensors(got)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert _rel(t, j) <= 1e-5
    w_in = got["blocks"][0]["mixer"]["w_in"]
    assert not torch.equal(w_in, tp["base"]["blocks"][0]["mixer"]["w_in"])
    assert torch.equal(got["blocks"][0]["mixer"]["conv_w"],
                       tp["base"]["blocks"][0]["mixer"]["conv_w"])


def test_engine_and_paged_pools_refuse_mamba():
    """The slot engine refuses jamba with the JAX engine's error before it
    touches a weight (a runtime whose base is None gets that far only),
    as JAX's ``Engine`` does; the paged pools refuse mamba positions."""
    _, _, _, cfg, spec, tp = _setup()
    rt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                              tp["frozen"])
    with pytest.raises(NotImplementedError, match="slot engine needs "
                       "attention KV caches; mixer 'mamba'"):
        Engine(cfg, dataclasses.replace(rt, base=None), device="cpu")
    with pytest.raises(NotImplementedError, match="mamba"):
        TT.init_paged_caches(cfg, 8, 16, torch.float32, device="cpu")


def test_check_supported_still_refuses_xlstm_and_enc_dec():
    """The model slice takes xLSTM mixers and enc-dec models now
    (``check_supported`` passes them), but the slot engine still refuses
    both before it touches a weight, as the JAX engine does."""
    cfg = tconfigs.get_smoke_config(ARCH)
    xl = dataclasses.replace(cfg, block_pattern=(("mlstm", "none"),),
                             num_layers=1)
    ed = dataclasses.replace(cfg, block_pattern=(("attn", "dense"),),
                             num_layers=1, encoder_layers=2,
                             encoder_seq=16, frontend="audio_stub")
    rt = AdapterRuntime.build("live", None, tpeft.NONE, None, None)
    for ok, msg in ((xl, "mixer 'mlstm'"), (ed, "enc-dec serving")):
        TT.check_supported(ok)
        with pytest.raises(NotImplementedError, match=msg):
            Engine(ok, rt, device="cpu")
