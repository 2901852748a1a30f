"""paligemma-3b and the ``patch_stub`` prefix in the port against the JAX
package (f32, on the CPU).

paligemma-3b is gemma's backbone (18 layers, d 2048, 8 heads over 1 kv
head of 256, GeGLU) behind 256 stub patch embeddings (``embeds``), which
are prepended to the text under the causal mask. On the card it is
prefilled, decoded, served and trained at full width and full depth
(``chip_smoke.py`` phase 22). Here, on its smoke config (2 layers, d 64, a
prefix of 8), with weights made by the JAX package (its PRNG) and carried
across with ``repro_torch.convert.from_jax_numpy``, and inputs made with
numpy:

* the smoke and full configs field by field, the assigned values and the
  full config's base and adapter parameters equal to JAX's;
* ``forward(embeds=)``: logits within 1e-5 of JAX's, caches over Tp + T
  rows;
* ``next_token_loss(prefix_len=8)`` with and without a mask (1e-5), and
  the loss over a batch with ``embeds`` with its adapter gradients
  (1e-5), then two train steps (the ``test_models_smoke`` case);
* ``make_prefill(embeds=)`` then ``make_serve_step`` decode equal to
  JAX's (1e-5) and to the parallel forward (JAX's 2e-2); greedy tokens
  after a prefix prefill identical to JAX's;
* one ``Trainer`` step over batches with ``embeds`` (loss and gradient
  norm 1e-5);
* the text-only paged ``Engine`` token-identical to JAX's.

Every JAX run is made once for the module (``jax_runs``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import SHAPES
from repro.config.base import ServeConfig as JServeConfig
from repro.config.base import TrainConfig as JTrainConfig
from repro.core import tt as jtt
from repro.data import LMStream as JLMStream
from repro.models import model as JM
from repro.models import transformer as JT
from repro.peft import api as jpeft
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import engine as jengine
from repro.serving.adapter_runtime import AdapterRuntime as JRuntime
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.config.base import (OptimizerConfig, RunConfig, ServeConfig,
                                     TrainConfig)
from repro_torch.convert import from_jax_numpy
from repro_torch.data import LMStream
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.peft import api as tpeft
from repro_torch.serving import AdapterRuntime, Engine, Request
from repro_torch.serving import engine as tengine
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

ARCH = "paligemma-3b"
KEY = jax.random.PRNGKey(23)
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
SCALE = 0.1            # the adapter's ``random_tt`` scale
B, S, P, G = 2, 8, 5, 4    # batch, tokens, prompt of prefill + decode, greedy
OPT = dict(lr=2e-2, warmup_ratio=0.1)


def _rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _runs(cfg, jcfg, **kw):
    common = dict(adapter_kind="metatt", adapter_variant="4d",
                  adapter_rank=4, **kw)
    return (JRunConfig(model=jcfg, shape=SHAPES["train_4k"], **common),
            RunConfig(model=cfg, **common))


@pytest.fixture(scope="module")
def setup():
    """The smoke config in both packages with a MetaTT-4d adapter on q / v
    at rank 4, ``random_tt(SCALE)``, made by the JAX package. Returns
    (jcfg, jspec, jp, cfg, spec, tp)."""
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


def _patches(cfg, b, seed=1):
    """Stub patch embeddings (B, frontend_seq, d)."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)


def _greedy(prefill, step, weights, prompt, patches, tp_len, argmax):
    """A prefix prefill of ``prompt`` then G - 1 greedy decode steps from
    position Tp + P: the G tokens (B, G)."""
    logits, caches, _ = prefill(*weights, prompt, embeds=patches)
    tok = argmax(logits[:, -1])[:, None]
    out = [tok]
    for i in range(G - 1):
        lg, caches = step(*weights, tok, caches, tp_len + P + i)
        tok = argmax(lg)[:, None]
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], 1)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Every JAX run the tests compare with, made once: the parallel
    forward over the prefix and S tokens, a prefix prefill of P tokens
    then S - P decode steps and a greedy run through ``make_prefill`` /
    ``make_serve_step``, the prefix loss with its adapter gradients, two
    train steps and one Trainer step."""
    jcfg, jspec, jp, cfg, _, _ = setup
    tpl = cfg.frontend_seq
    bc, pl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    toks, patches = _tokens(cfg, B, S), _patches(cfg, B)
    fwd = jax.jit(lambda t, e: dataclasses.astuple(JT.forward(
        jp["base"], jcfg, jspec, bc, pl, t, embeds=e)))
    out = JT.ModelOutputs(*fwd(jnp.asarray(toks), jnp.asarray(patches)))
    prefill = jengine.make_prefill(jcfg, jspec, tpl + S)
    step = jengine.make_serve_step(jcfg, jspec)
    w = (jp["base"], jp["adapter"], jp["frozen"])
    pre, caches, _ = prefill(*w, jnp.asarray(toks[:, :P]),
                             embeds=jnp.asarray(patches))
    after = []
    for t in range(P, S):
        lg, caches = step(*w, jnp.asarray(toks[:, t:t + 1]), caches,
                          jnp.int32(tpl + t))
        after.append(np.asarray(lg))
    gprefill = jengine.make_prefill(jcfg, jspec, tpl + P + G)
    greedy = _greedy(gprefill, lambda *a: step(*a[:-1], jnp.int32(a[-1])), w,
                     jnp.asarray(toks[:, :P]), jnp.asarray(patches), tpl,
                     lambda x: jnp.argmax(x, -1))
    rng = np.random.default_rng(7)
    gtoks, gpatches = _tokens(cfg, 3, 11, seed=8), _patches(cfg, 3, seed=9)
    mask = (rng.random((3, 11)) > 0.2).astype(np.float32)
    batch = {"tokens": jnp.asarray(gtoks), "mask": jnp.asarray(mask),
             "embeds": jnp.asarray(gpatches)}
    (jl, _), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                          static_argnums=(4, 5))(
        jp["adapter"], jp["base"], jp["frozen"], batch, jcfg, jspec)
    return dict(toks=toks, patches=patches, logits=np.asarray(out.logits),
                k=np.asarray(out.caches[0]["self"]["k"]),
                prefill=np.asarray(pre), after=np.stack(after, 1),
                greedy=greedy, gtoks=gtoks, gpatches=gpatches, mask=mask,
                loss=float(jl), grads=jax.tree_util.tree_leaves(jg))


def _factors(spec, tp):
    return tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])


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
    assert cfg.padded_vocab == jcfg.padded_vocab
    TT.check_supported(cfg)
    if not smoke:   # tests/test_models_smoke.py's assigned values
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size,
                cfg.num_experts, cfg.experts_per_token) == (
            18, 2048, 8, 1, 16384, 257216, 0, 0)
        assert (cfg.frontend, cfg.frontend_seq, cfg.head_dim) == (
            "patch_stub", 256, 256)


def test_full_width_parameter_counts_match_jax():
    """Base (2.51 B) and 4d adapter parameters of full-width paligemma-3b
    from shapes alone in both packages."""
    cfg, jcfg = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    jrun, trun = _runs(cfg, jcfg, adapter_alpha=4.0)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    assert spec.cfg.mode_sizes == jspec.cfg.mode_sizes
    got = TM.count_params(TM.init_params(cfg, spec, device="meta"))
    want = JM.count_params(jax.eval_shape(
        lambda: JM.init_params(jcfg, jspec, KEY)))
    assert got == want
    assert 2.5e9 < got["base"] < 2.52e9


# ---------------------------------------------------------------------------
# the smoke model with its prefix
# ---------------------------------------------------------------------------


def _forward(setup, toks, patches, **kw):
    _, _, _, cfg, spec, tp = setup
    bc, pl = _factors(spec, tp)
    with torch.no_grad():
        return TT.forward(tp["base"], cfg, spec, bc, pl, toks,
                          embeds=torch.from_numpy(patches), device="cpu",
                          **kw)


def test_forward_with_embeds_matches_jax(setup, jax_runs):
    """The prefix rows run through the blocks before the tokens: logits
    (B, Tp + T, V) and the k cache (Tp + T cells) within 1e-5 of JAX's."""
    cfg = setup[3]
    out = _forward(setup, jax_runs["toks"], jax_runs["patches"],
                   return_caches=True)
    assert out.logits.shape == (B, cfg.frontend_seq + S, cfg.padded_vocab)
    assert _rel(out.logits, jax_runs["logits"]) <= 1e-5
    assert _rel(out.caches[0]["self"]["k"], jax_runs["k"]) <= 1e-5


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
def test_next_token_loss_with_a_prefix_matches_jax(masked):
    """``next_token_loss(prefix_len=8)`` over random logits (B, 8 + T, V)
    with padded vocab columns: the last patch position predicts text token
    0, the last position nothing; with a per-target mask too (1e-5)."""
    rng = np.random.default_rng(3)
    b, t, tpl, v = 3, 6, 8, 12
    logits = rng.standard_normal((b, tpl + t, v)).astype(np.float32)
    toks = rng.integers(0, 10, (b, t))
    mask = (rng.random((b, t)) > 0.3).astype(np.float32) if masked else None
    got = TM.next_token_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                             None if mask is None else torch.from_numpy(mask),
                             tpl, vocab_size=10)
    want = JM.next_token_loss(jnp.asarray(logits), jnp.asarray(toks),
                              None if mask is None else jnp.asarray(mask),
                              tpl, vocab_size=10)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    # the prefix rows' own targets do not count: changing the logits at
    # positions 0 .. Tp - 2 leaves the loss as it was
    moved = logits.copy()
    moved[:, :tpl - 1] += 5.0
    again = TM.next_token_loss(torch.from_numpy(moved),
                               torch.from_numpy(toks),
                               None if mask is None
                               else torch.from_numpy(mask), tpl,
                               vocab_size=10)
    assert float(again) == float(got)


def test_prefix_loss_gradients_and_train_steps(setup, jax_runs):
    """The loss over a batch with ``embeds`` and a mask (1e-5) and its
    adapter gradients (1e-5 of the largest); then the
    ``test_models_smoke`` case: two train steps on the batch, finite loss,
    a nonzero gradient."""
    _, _, _, cfg, spec, tp = setup
    batch = {"tokens": torch.from_numpy(jax_runs["gtoks"]),
             "mask": torch.from_numpy(jax_runs["mask"]),
             "embeds": torch.from_numpy(jax_runs["gpatches"])}
    cores = [c.detach().clone().requires_grad_(True)
             for c in tp["adapter"]["cores"]]
    loss, _ = TM.loss_fn({"cores": cores}, tp["base"], tp["frozen"], batch,
                         cfg, spec, device="cpu")
    grads = torch.autograd.grad(loss, cores)
    assert abs(loss.item() - jax_runs["loss"]) <= 1e-5 * jax_runs["loss"]
    assert len(grads) == len(jax_runs["grads"])
    for g, w in zip(grads, jax_runs["grads"]):
        assert _rel(g, w) <= 1e-5
    run = RunConfig(model=cfg, adapter_kind="metatt", adapter_rank=4,
                    train=TrainConfig(remat="none"))
    step = tts.make_train_step(cfg, spec, run.optimizer, run.train,
                               total_steps=10, device="cpu")
    state = tts.init_train_state(tp["adapter"])
    for _ in range(2):
        state, m = step(state, tp["base"], tp["frozen"], batch)
        assert np.isfinite(float(m["loss"]))
        assert float(m["grad_norm"]) > 0


def test_decode_after_a_prefix_prefill_matches_jax_and_the_forward(
        setup, jax_runs):
    """``make_prefill(embeds=)`` over Tp patches and P tokens, then S - P
    ``make_serve_step`` decode steps from position Tp + P: the prefill
    logits and every step within 1e-5 of JAX's, and the steps within
    2e-2 of the parallel forward over the whole sequence (JAX's
    ``test_decode_matches_parallel_forward`` bar)."""
    _, _, _, cfg, spec, tp = setup
    tpl = cfg.frontend_seq
    toks = torch.from_numpy(jax_runs["toks"])
    w = (tp["base"], tp["adapter"], tp["frozen"])
    prefill = tengine.make_prefill(cfg, spec, tpl + S, device="cpu")
    step = tengine.make_serve_step(cfg, spec, device="cpu")
    with torch.no_grad():
        pre, caches, enc = prefill(
            *w, toks[:, :P], embeds=torch.from_numpy(jax_runs["patches"]))
        assert enc is None
        assert caches[0]["self"]["k"].shape[2] == tpl + S
        after = torch.stack([step(*w, toks[:, t:t + 1], caches, tpl + t)[0]
                             for t in range(P, S)], 1)
    assert _rel(pre, jax_runs["prefill"]) <= 1e-5
    assert _rel(after, jax_runs["after"]) <= 1e-5
    assert _rel(after, jax_runs["logits"][:, tpl + P:tpl + S]) \
        < 2e-2


def test_greedy_prefix_prefill_and_decode_token_identical_to_jax(
        setup, jax_runs):
    """A prefix prefill of P tokens and G - 1 greedy decode steps through
    the port's ``make_prefill`` / ``make_serve_step``: the G tokens of
    each row identical to JAX's."""
    _, _, _, cfg, spec, tp = setup
    w = (tp["base"], tp["adapter"], tp["frozen"])
    with torch.no_grad():
        got = _greedy(
            tengine.make_prefill(cfg, spec, cfg.frontend_seq + P + G,
                                 device="cpu"),
            tengine.make_serve_step(cfg, spec, device="cpu"), w,
            torch.from_numpy(jax_runs["toks"][:, :P]),
            torch.from_numpy(jax_runs["patches"]), cfg.frontend_seq,
            lambda x: torch.argmax(x, -1))
    assert got.tolist() == jax_runs["greedy"].tolist()


class _WithPatches:
    """An LM stream whose batches carry seeded patch embeddings."""

    def __init__(self, stream, cfg):
        self.stream, self.cfg = stream, cfg

    def __next__(self):
        step = self.stream.state()["step"]
        batch = next(self.stream)
        batch["embeds"] = np.random.default_rng((5, step)).standard_normal(
            (batch["tokens"].shape[0], self.cfg.frontend_seq,
             self.cfg.d_model)).astype(np.float32)
        return batch

    def __iter__(self):
        return self


def test_trainer_step_with_embeds_matches_jax():
    """One Trainer step over a batch with ``embeds``, both packages from
    the same JAX-made weights: loss and gradient norm within 1e-5."""
    cfg, jcfg = (tconfigs.get_smoke_config(ARCH),
                 jconfigs.get_smoke_config(ARCH))
    tr_kw = {"seed": 3, "remat": "none", "ckpt_every": 0}
    common = dict(adapter_kind="metatt", adapter_variant="4d",
                  adapter_rank=4, adapter_alpha=4.0)
    jrun = JRunConfig(model=jcfg, shape=SHAPES["train_4k"],
                      optimizer=JOptimizerConfig(**OPT),
                      train=JTrainConfig(**tr_kw), **common)
    trun = RunConfig(model=cfg, optimizer=OptimizerConfig(**OPT),
                     train=TrainConfig(**tr_kw), **common)

    def lm(pkg):
        return _WithPatches(pkg(vocab_size=cfg.vocab_size, seq_len=12,
                                batch=2, seed=11, branching=2), cfg)
    jtr = JTrainer(run=jrun, data=lm(JLMStream), total_steps=1)
    tr = Trainer(run=trun, data=lm(LMStream), total_steps=1, device="cpu")
    tp = from_jax_numpy(jax.device_get(
        {"base": jtr.base, "frozen": jtr.frozen,
         "adapter": jtr.state.adapter}), device="cpu")
    tr.base, tr.frozen = tp["base"], tp["frozen"]
    tr.state = tts.init_train_state(tp["adapter"])
    jtr.train()
    tr.train()
    (_, got), (_, want) = tr.history[0], jtr.history[0]
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(
            float(want[k])), k
    assert tr.state.opt.step == 1


def test_text_only_paged_engine_token_identical_to_jax(setup):
    """The slot engine serves paligemma text-only (it takes no
    ``embeds``, as JAX's does): 4 requests through the paged engine,
    tokens identical to the JAX paged engine's, with equal counters."""
    jcfg, jspec, jp, cfg, spec, tp = setup
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    trt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                               tp["frozen"])
    sv = dict(max_batch=2, cache_len=32, out_cap=8, page_size=8,
              prefill_chunk=4)
    jeng = JEngine(jcfg, jrt, serve=JServeConfig(**sv))
    teng = Engine(cfg, trt, serve=ServeConfig(**sv), device="cpu")
    work = [(_tokens(cfg, 1, 4 + i, seed=20 + i)[0], 5 + i % 3)
            for i in range(4)]
    want = [np.asarray(o).tolist()
            for o in jeng.generate([JRequest(p, n) for p, n in work])]
    got = [o.tolist() for o in teng.generate([Request(p, n)
                                              for p, n in work])]
    assert got == want
    for name in ("admitted", "evicted", "kv_blocks_peak",
                 "tokens_generated"):
        assert getattr(teng.last_stats, name) == \
            getattr(jeng.last_stats, name), name
    assert teng.leaked_blocks() == 0


def test_single_shot_helpers_default_to_cuda(setup):
    """``make_prefill`` and ``make_serve_step`` run on the CUDA device
    unless the caller asks for the CPU: without a card they raise rather
    than fall back."""
    _, _, _, cfg, spec, tp = setup
    if torch.cuda.is_available():
        return
    w = (tp["base"], tp["adapter"], tp["frozen"])
    toks = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.make_prefill(cfg, spec, 16)(*w, toks)
    caches = TT.init_caches(cfg, 1, 16, torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.make_serve_step(cfg, spec)(*w, toks[:, :1], caches, 0)
