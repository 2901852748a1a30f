"""The encoder-decoder and whisper-large-v3 in the port against the JAX
package (f32, on the CPU).

whisper-large-v3 is 32 encoder and 32 decoder layers of 20 heads of 64
with layernorm, gelu and a cross-attention in every decoder layer; the
encoder takes 1536 stub frame embeddings (``enc_embeds``). On the card it
is prefilled, decoded and trained at full width and full depth
(``chip_smoke.py`` phase 21). Here, on its smoke config (2 + 2 layers,
an encoder sequence of 16), with weights made by the JAX package (its
PRNG) and carried across with ``repro_torch.convert.from_jax_numpy``,
and inputs made with numpy:

* the smoke and full configs field by field, the full config's base and
  4d adapter parameters equal to JAX's (meta device / ``jax.eval_shape``);
* cross-attention (``models/attention.py`` with ``kv_x``) within 1e-5 of
  JAX's, computing the encoder k / v and keeping no cache;
* the encoder output ``enc_out`` and the decoder's logits within 1e-5;
* token-by-token decode from zero caches (the cross k / v recomputed
  from ``enc_out`` each step, as in JAX) equal to JAX's decode (1e-5)
  and to the parallel forward
  (``tests/test_serving.py::test_decode_matches_parallel_forward``'s
  2e-2); a prefill of 5 tokens then 3 decode steps equal to JAX's
  (1e-5); a 4+1d decode with a per-row task vector (1e-5);
* the MetaTT-4d loss over ``enc_embeds`` (1e-5) and its gradients
  (1e-4), plain and with remat; ten Trainer steps against the JAX
  Trainer (1e-4, 1e-3 after the sweep), the batches carrying
  ``enc_embeds``;
* the folds of self- and cross-attention adapters over the encoder and
  the decoder (1e-5);
* the engine refuses the encoder-decoder as the JAX engine does.

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
from repro.config.base import TrainConfig as JTrainConfig
from repro.core import merge as jmerge
from repro.core import tt as jtt
from repro.core.dmrg import RankSchedule as JRankSchedule
from repro.data import LMStream as JLMStream
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.layers import AdapterCtx as JCtx
from repro.peft import api as jpeft
from repro.serving import engine as jengine
from repro.serving.adapter_runtime import AdapterRuntime as JRuntime
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.config.base import OptimizerConfig, RunConfig, TrainConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core import merge as tmerge
from repro_torch.core.dmrg import RankSchedule
from repro_torch.data import LMStream
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.layers import AdapterCtx
from repro_torch.peft import api as tpeft
from repro_torch.serving import AdapterRuntime, Engine
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

ARCH = "whisper-large-v3"
KEY = jax.random.PRNGKey(33)
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
#: the adapter's ``random_tt`` scale (the JAX serving test's)
SCALE = 0.1
B, S, P = 2, 8, 5     # batch, decoder tokens, prompt of prefill-then-decode
OPT = dict(lr=2e-2, warmup_ratio=0.1)


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


def _runs(cfg, jcfg, variant="4d", **kw):
    common = dict(adapter_kind="metatt", adapter_variant=variant,
                  adapter_rank=4, **kw)
    if variant == "4+1d":
        common["num_tasks"] = 3
    return (JRunConfig(model=jcfg, shape=SHAPES["train_4k"], **common),
            RunConfig(model=cfg, **common))


def _make(variant, **kw):
    """The smoke config in both packages with a MetaTT adapter of
    ``variant`` at rank 4 (default matrices: self- and cross-attention
    q / v), ``random_tt(SCALE)``, made by the JAX package. Returns (jcfg,
    jspec, jp, cfg, spec, tp)."""
    jcfg, cfg = (jconfigs.get_smoke_config(ARCH),
                 tconfigs.get_smoke_config(ARCH))
    jrun, trun = _runs(cfg, jcfg, variant, **kw)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = jax.jit(JM.init_params, static_argnums=(0, 1))(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=SCALE)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    return jcfg, jspec, jp, cfg, spec, tp


@pytest.fixture(scope="module")
def setup():
    return _make("4d")


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))


def _frames(cfg, b, seed=1):
    """Stub frame embeddings (B, encoder_seq, d)."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _factors(spec, tp):
    return tpeft.adapter_factors(spec, tp["adapter"], tp["frozen"])


def _pad_self(caches, p, s):
    """A prefill's per-position caches (k / v of ``p`` cells) placed in
    zero caches of ``s`` cells (JAX arrays)."""
    return jax.tree_util.tree_map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, s - p), (0, 0), (0, 0))),
        caches)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Every JAX run the model tests compare with, made once: the
    parallel forward (logits, enc_out), token-by-token decode from zero
    caches, a prefill of P tokens then S - P decode steps, and the loss
    with its adapter gradients."""
    jcfg, jspec, jp, cfg, _, _ = setup
    bc, pl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    toks, frames = _tokens(cfg, B, S), _frames(cfg, B)
    fwd = jax.jit(lambda t, e: dataclasses.astuple(JT.forward(
        jp["base"], jcfg, jspec, bc, pl, t, enc_embeds=e)))
    out = JT.ModelOutputs(*fwd(jnp.asarray(toks), jnp.asarray(frames)))
    step = jax.jit(lambda t, c, p, e: JT.decode_step(
        jp["base"], jcfg, jspec, bc, pl, t, c, p, enc_out=e))
    caches = JT.init_caches(jcfg, B, S, jnp.float32)
    dec = []
    for t in range(S):
        lg, caches = step(jnp.asarray(toks[:, t:t + 1]), caches,
                          jnp.int32(t), out.enc_out)
        dec.append(np.asarray(lg))
    pre = JT.ModelOutputs(*fwd(jnp.asarray(toks[:, :P]),
                               jnp.asarray(frames)))
    caches = _pad_self(pre.caches, P, S)
    after = []
    for t in range(P, S):
        lg, caches = step(jnp.asarray(toks[:, t:t + 1]), caches,
                          jnp.int32(t), pre.enc_out)
        after.append(np.asarray(lg))
    rng = np.random.default_rng(7)
    gtoks = _tokens(cfg, 3, 13, seed=8)
    gframes = _frames(cfg, 3, seed=9)
    mask = (rng.random((3, 13)) > 0.2).astype(np.float32)
    (jl, _), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                          static_argnums=(4, 5))(
        jp["adapter"], jp["base"], jp["frozen"],
        {"tokens": jnp.asarray(gtoks), "mask": jnp.asarray(mask),
         "enc_embeds": jnp.asarray(gframes)}, jcfg, jspec)
    return dict(toks=toks, frames=frames, logits=np.asarray(out.logits),
                enc_out=np.asarray(out.enc_out), decode=np.stack(dec, 1),
                prefill=np.asarray(pre.logits), after=np.stack(after, 1),
                gtoks=gtoks, gframes=gframes, mask=mask, loss=float(jl),
                grads=jax.tree_util.tree_leaves(jg))


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
    assert cfg.is_encdec and cfg.total_layers == jcfg.total_layers
    TT.check_supported(cfg)
    if not smoke:   # tests/test_models_smoke.py's assigned values
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size,
                cfg.encoder_layers, cfg.encoder_seq, cfg.total_layers) == (
            32, 1280, 20, 20, 5120, 51866, 32, 1536, 64)
    spec = TM.build_adapter_spec(RunConfig(model=cfg))
    jspec = JM.build_adapter_spec(JRunConfig(model=jcfg,
                                             shape=SHAPES["train_4k"]))
    assert spec.cfg.matrix_types == jspec.cfg.matrix_types == (
        "attn_q", "attn_v", "xattn_q", "xattn_v")
    assert spec.cfg.num_layers == cfg.total_layers
    assert TM.matrix_dims(cfg) == JM.matrix_dims(jcfg)
    assert spec.cfg.mode_sizes == jspec.cfg.mode_sizes


def test_full_width_parameter_counts_match_jax():
    """Base and 4d adapter parameters of full-width whisper-large-v3 from
    shapes alone in both packages (encoder, decoder with
    cross-attention)."""
    cfg, jcfg = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    jrun, trun = _runs(cfg, jcfg, adapter_alpha=4.0)
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    got = TM.count_params(TM.init_params(cfg, spec, device="meta"))
    want = JM.count_params(jax.eval_shape(
        lambda: JM.init_params(jcfg, jspec, KEY)))
    assert got == want
    assert got["base"] > 1.5e9


def test_patch_stub_frontend_is_refused():
    """The ``patch_stub`` prefix (paligemma) is ported: ``check_supported``
    takes it, and the slot engine builds for the smoke paligemma config
    (it serves text only, as the JAX engine does; the prefix itself is
    held to JAX in ``tests/test_torch_paligemma.py``)."""
    cfg = tconfigs.get_smoke_config(ARCH)
    prefix = dataclasses.replace(cfg, encoder_layers=0, encoder_seq=0,
                                 frontend="patch_stub", frontend_seq=4)
    TT.check_supported(prefix)
    pcfg = tconfigs.get_smoke_config("paligemma-3b")
    TT.check_supported(pcfg)
    spec = TM.build_adapter_spec(RunConfig(model=pcfg))
    tp = TM.init_params(pcfg, spec, torch.Generator().manual_seed(0),
                        device="cpu")
    rt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                              tp["frozen"])
    eng = Engine(pcfg, rt, device="cpu")
    assert eng.paged and eng.cfg.frontend == "patch_stub"


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------


def test_cross_attention_matches_jax_and_reuses_a_kv_cache(setup):
    """Decoder layer 0's cross-attention over an encoder output: T = 3
    queries against S = 16 keys, no rope, not causal, within 1e-5 of
    JAX's; it returns no cache, and a cache passed to it raises: the port
    keeps no cross k / v (a decode step recomputes them from the encoder
    output, as the JAX decode path does), so JAX's reuse of a cached
    "k" has no counterpart."""
    jcfg, jspec, jp, cfg, spec, tp = setup
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    tbc, tpl = _factors(spec, tp)
    lay = cfg.encoder_layers      # the decoder's first layer
    jw = jax.tree_util.tree_map(lambda a: a[0], jp["base"]["blocks"][0]
                                ["xattn"])
    tw = TT._at(tp["base"]["blocks"][0]["xattn"], 0)
    jctx = JCtx(jspec, jbc, jax.tree_util.tree_map(lambda a: a[lay], jpl))
    tctx = AdapterCtx(spec, tbc, TT._at(tpl, lay))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 3, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    jy, _ = jattn.attention(jnp.asarray(x), jw, jctx, jcfg,
                            kv_x=jnp.asarray(enc), causal=False,
                            prefix="xattn", use_rope=False)
    kw = dict(causal=False, prefix="xattn", kv_x=torch.from_numpy(enc))
    with torch.no_grad():
        y, none = tattn.attention(torch.from_numpy(x), tw, tctx, cfg, **kw)
        with pytest.raises(ValueError, match="no cache"):
            tattn.attention(torch.from_numpy(x), tw, tctx, cfg, cache={},
                            **kw)
    assert none is None
    assert _rel(y, jy) <= 1e-5


# ---------------------------------------------------------------------------
# the smoke model
# ---------------------------------------------------------------------------


def _forward(setup, toks, frames, **kw):
    _, _, _, cfg, spec, tp = setup
    bc, pl = _factors(spec, tp)
    with torch.no_grad():
        return TT.forward(tp["base"], cfg, spec, bc, pl, toks,
                          enc_embeds=torch.from_numpy(frames),
                          device="cpu", **kw)


def test_enc_out_and_logits_match_jax(setup, jax_runs):
    out = _forward(setup, jax_runs["toks"], jax_runs["frames"],
                   return_caches=True)
    assert _rel(out.enc_out, jax_runs["enc_out"]) <= 1e-5
    assert _rel(out.logits, jax_runs["logits"]) <= 1e-5
    cfg = setup[3]
    assert [next(iter(c)) for c in out.caches] == ["self"]
    assert out.caches[0]["self"]["k"].shape == (
        cfg.num_super_blocks, B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    with pytest.raises(ValueError, match="enc_embeds"):
        TT.forward(setup[5]["base"], cfg, setup[4], *_factors(setup[4],
                                                              setup[5]),
                   jax_runs["toks"], device="cpu")


def _decode(setup, toks, caches, start, enc_out, **kw):
    _, _, _, cfg, spec, tp = setup
    bc, pl = _factors(spec, tp)
    with torch.no_grad():
        return torch.stack([TT.decode_step(
            tp["base"], cfg, spec, bc, pl, toks[:, t:t + 1], caches, t,
            enc_out=enc_out, device="cpu", **kw)[0]
            for t in range(start, toks.shape[1])], 1)


def test_decode_from_zero_caches_matches_jax_and_the_parallel_forward(
        setup, jax_runs):
    """Token-by-token decode from ``init_caches`` zeros with the port's
    own ``enc_out``: every step within 1e-5 of JAX's decode, and of the
    parallel forward within the JAX serving test's 2e-2."""
    cfg = setup[3]
    enc_out = _forward(setup, jax_runs["toks"], jax_runs["frames"]).enc_out
    caches = TT.init_caches(cfg, B, S, torch.float32, device="cpu")
    assert [list(c) for c in caches] == [["self"]]   # no cross cache
    dec = _decode(setup, jax_runs["toks"], caches, 0, enc_out)
    assert _rel(dec, jax_runs["decode"]) <= 1e-5
    assert _rel(dec, jax_runs["logits"]) < 2e-2


def test_prefill_then_decode_matches_jax(setup, jax_runs):
    """A prefill of P tokens over the frames (its k / v placed in caches
    of S cells), then S - P decode steps with its ``enc_out``: the
    prefill's and every step's logits within 1e-5 of JAX's."""
    cfg = setup[3]
    toks = jax_runs["toks"]
    pre = _forward(setup, toks[:, :P], jax_runs["frames"],
                   return_caches=True)
    caches = TT.init_caches(cfg, B, S, torch.float32, device="cpu")
    for dst, src in zip(caches, pre.caches):
        for name, t in src["self"].items():
            dst["self"][name][:, :, :P] = t
    after = _decode(setup, toks, caches, P, pre.enc_out)
    assert _rel(pre.logits, jax_runs["prefill"]) <= 1e-5
    assert _rel(after, jax_runs["after"]) <= 1e-5
    assert _rel(after, jax_runs["logits"][:, P:]) < 2e-2


def test_per_row_task_decode_matches_jax():
    """MetaTT 4+1d over 3 tasks with a (B,) task vector: three decode
    steps from zero caches against a given encoder output (JAX's encoder
    takes no task, so its 4+1d forward cannot make one): logits and k / v
    within 1e-5."""
    jcfg, jspec, jp, cfg, spec, tp = _make("4+1d")
    jbc, jpl = jpeft.adapter_factors(jspec, jp["adapter"], jp["frozen"])
    bc, pl = _factors(spec, tp)
    toks = _tokens(cfg, 3, 3, seed=9)
    enc = _frames(cfg, 3, seed=10)
    task = np.array([2, 0, 1], np.int32)
    step = jax.jit(lambda t, c, p: JT.decode_step(
        jp["base"], jcfg, jspec, jbc, jpl, t, c, p, enc_out=jnp.asarray(enc),
        task=jnp.asarray(task)))
    jc = JT.init_caches(jcfg, 3, 3, jnp.float32)
    caches = TT.init_caches(cfg, 3, 3, torch.float32, device="cpu")
    for t in range(3):
        want, jc = step(jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        with torch.no_grad():
            got, caches = TT.decode_step(
                tp["base"], cfg, spec, bc, pl, toks[:, t:t + 1], caches, t,
                enc_out=torch.from_numpy(enc), task=torch.from_numpy(task),
                device="cpu")
        assert _rel(got, want) <= 1e-5
    for name in ("k", "v"):
        assert _rel(caches[0]["self"][name], jc[0]["self"][name]) <= 1e-5


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_adapter_grads_match_jax(setup, jax_runs, remat):
    _, _, _, cfg, spec, tp = setup
    adapter = {"cores": [c.clone().requires_grad_(True)
                         for c in tp["adapter"]["cores"]]}
    loss, _ = TM.loss_fn(adapter, tp["base"], tp["frozen"],
                         {"tokens": torch.from_numpy(jax_runs["gtoks"]),
                          "mask": torch.from_numpy(jax_runs["mask"]),
                          "enc_embeds": torch.from_numpy(
                              jax_runs["gframes"])},
                         cfg, spec, remat=remat, device="cpu")
    jl = jax_runs["loss"]
    assert abs(float(loss.detach()) - jl) <= 1e-5 * abs(jl)
    grads = torch.autograd.grad(loss, TM.tensors(adapter))
    assert len(grads) == len(jax_runs["grads"]) == 4
    for g, want in zip(grads, jax_runs["grads"]):
        assert float(np.abs(np.asarray(want)).max()) > 0
        assert _fro(g, want) <= 1e-4


class _WithFrames:
    """An LM stream whose batches also carry stub frame embeddings,
    drawn from the stream's step (the same in both packages)."""

    def __init__(self, stream, cfg):
        self.stream, self.cfg = stream, cfg

    def __next__(self):
        step = self.stream.state()["step"]
        batch = next(self.stream)
        batch["enc_embeds"] = np.random.default_rng((5, step)).standard_normal(
            (batch["tokens"].shape[0], self.cfg.encoder_seq,
             self.cfg.d_model)).astype(np.float32)
        return batch

    def __iter__(self):
        return self


def test_trainer_with_a_dmrg_sweep_tracks_the_jax_trainer():
    """Ten steps over batches with ``enc_embeds``, one warm-moment sweep
    6 -> 4 after epoch 1 (step 3): losses within 1e-4 before the sweep
    and 1e-3 after it."""
    cfg, jcfg = (tconfigs.get_smoke_config(ARCH),
                 jconfigs.get_smoke_config(ARCH))
    tr_kw = {"seed": 3, "remat": "none", "ckpt_every": 0}
    common = dict(adapter_kind="metatt", adapter_variant="4d",
                  adapter_rank=6, adapter_alpha=4.0)
    jrun = JRunConfig(model=jcfg, shape=SHAPES["train_4k"],
                      optimizer=JOptimizerConfig(**OPT),
                      train=JTrainConfig(**tr_kw), **common)
    trun = RunConfig(model=cfg, optimizer=OptimizerConfig(**OPT),
                     train=TrainConfig(**tr_kw), **common)

    def lm(pkg):
        return _WithFrames(pkg(vocab_size=cfg.vocab_size, seq_len=16,
                               batch=4, seed=11, branching=2), cfg)
    jtr = JTrainer(run=jrun, data=lm(JLMStream), total_steps=10,
                   steps_per_epoch=3,
                   rank_schedule=JRankSchedule(milestones=((1, 4),)))
    tr = Trainer(run=trun, data=lm(LMStream), total_steps=10,
                 steps_per_epoch=3,
                 rank_schedule=RankSchedule(milestones=((1, 4),)),
                 device="cpu")
    tp = from_jax_numpy(jax.device_get(
        {"base": jtr.base, "frozen": jtr.frozen,
         "adapter": jtr.state.adapter}), device="cpu")
    tr.base, tr.frozen = tp["base"], tp["frozen"]
    tr.state = tts.init_train_state(tp["adapter"])
    jtr.train()
    tr.train()
    assert tr._dmrg_applied == jtr._dmrg_applied == [1]
    a, b = tr.losses(), jtr.losses()
    rel = np.abs(a - b) / np.abs(b)
    assert rel[:3].max() <= 1e-4 and rel[3:].max() <= 1e-3, rel
    assert np.isfinite(a).all() and tr.state.opt.step == 10


def test_encdec_folds_match_jax():
    """``fold_transformer`` of a 4d adapter on the self- and
    cross-attention q / k / v / o over the encoder (layer ids 0, 1) and
    the decoder (2, 3) as JAX folds it (1e-5); the FFNs unchanged."""
    types = ("attn_q", "attn_k", "attn_v", "attn_o", "xattn_q", "xattn_k",
             "xattn_v", "xattn_o")
    jcfg, jspec, jp, cfg, spec, tp = _make("4d", adapter_matrices=types)
    want = jmerge.fold_transformer(jp["adapter"], jspec.cfg, jp["base"],
                                   jcfg)
    got = tmerge.fold_transformer(tp["adapter"], spec.cfg, tp["base"], cfg)
    jl = jax.tree_util.tree_leaves(want)
    tl = TM.tensors(got)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert _rel(t, j) <= 1e-5
    for group, blk in (("enc_blocks", "mixer"), ("blocks", "mixer"),
                       ("blocks", "xattn")):
        for n in ("wq", "wk", "wv", "wo"):
            assert not torch.equal(got[group][0][blk][n],
                                   tp["base"][group][0][blk][n])
    assert torch.equal(got["enc_blocks"][0]["ffn"]["wu"],
                       tp["base"]["enc_blocks"][0]["ffn"]["wu"])


def test_engine_refuses_encdec(setup):
    """The slot engine refuses whisper with the JAX engine's error
    ("enc-dec serving is not slotted yet") before it touches a weight."""
    jcfg, jspec, jp, cfg, spec, tp = setup
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    rt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                              tp["frozen"])
    msg = "enc-dec serving is not slotted yet"
    with pytest.raises(NotImplementedError, match=msg):
        jengine.Engine(jcfg, jrt)
    with pytest.raises(NotImplementedError, match=msg):
        Engine(cfg, dataclasses.replace(rt, base=None), device="cpu")
