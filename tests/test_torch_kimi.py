"""kimi-k2's heads of 112 in the port against the JAX package (CPU).

kimi-k2 (d_model 7168: 64 heads of 112 over 8 KV heads) is served on the
card through the d = 112 instances of K3, K4, #8 and #8q, the d = 128
kernels on tiles padded in shared memory (``chip_smoke.py`` phase 17).
Here, with inputs made with numpy from a seed:

* the plain versions of K3, #5 (with lse), K4, #8 and #8q — what the card
  holds those instances to — at d = 112 and G = 8 against the JAX Pallas
  kernels in interpret mode and the JAX reference: bf16 within 2e-2
  (abs + rel), f32 within 1e-5 of the largest value (lse 1e-5); a case
  with large q·k in which the softmax scaled by 128^-0.5 (the tile
  width's) instead of 112^-0.5 misses that limit;
* a kimi smoke config at head_dim 112 (both packages' smoke configs with
  d_model 896, 8 heads over 1 KV head, 2 layers, 8 experts, one shared):
  the dense and the paged engine (a shared prefix, cold then warm) give
  greedy tokens identical to the JAX engines' in f32, with equal KV
  bytes — the pools hold 112 values a row;
* the device checks of the CUDA wrappers: bf16 at 112 passes for the
  forward, decode and backward (#6 / #7) kernels; head_dim 96 and f32 at
  112 raise ``NotImplementedError``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config.base import ServeConfig as JServeConfig
from repro.core import tt as jtt
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.models import model as JM
from repro.serving import AdapterRuntime as JRuntime
from repro.serving import Engine as JEngine

from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.config.base import ServeConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import model as TM
from repro_torch.serving import AdapterRuntime, Engine

from test_torch_moe import KEY, KIMI, _runs
from test_torch_moe_engines import BASE, PAGED_COUNTERS, _serve, _work

D, H, KV = 112, 8, 1          # kimi-k2's head_dim; G = 8, its group
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dt, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32) \
        .astype(DTYPES[dt][0])
    if dt == "bf16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _err(got, want, dt) -> float:
    """The miss against the limit of ``dt``: bf16 elementwise |got - want|
    / (2e-2 + 2e-2 |want|); f32 max |got - want| / (1e-5 max |want|). At
    most 1 passes."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if dt == "bf16":
        return float((np.abs(g - w) / (2e-2 + 2e-2 * np.abs(w))).max())
    return float(np.abs(g - w).max() / (1e-5 * np.abs(w).max()))


def _held(got, wants, dt):
    for want in wants:
        assert _err(got, want, dt) <= 1.0


def _wrong_scale(q):
    """q such that the plain version's 112^-0.5 acts as 128^-0.5."""
    return q * (D / 128) ** 0.5


# ---------------------------------------------------------------------------
# the plain versions at d = 112 against the Pallas kernels
# ---------------------------------------------------------------------------


CASES = [pytest.param(dt, qs, id=f"{dt}-q{qs}") for dt in ("f32", "bf16")
         for qs in (1.0, 4.0)]


@pytest.mark.parametrize("dt,qs", CASES)
def test_flash_attention_and_fwd_lse_at_d112(dt, qs):
    """K3 and #5 (out and lse), causal, T = S = 24, G = 8. At q x 4 the
    scores are large and the 128^-0.5 scale misses the limit."""
    rng = np.random.default_rng(112)
    jq, tq = _pair(rng, (1, 24, H, D), dt, qs)
    jk, tk = _pair(rng, (1, 24, KV, D), dt)
    jv, tv = _pair(rng, (1, 24, KV, D), dt)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert got.shape == (1, 24, H, D) and got.dtype == tq.dtype
    _held(got, [jops.flash_attention(jq, jk, jv, causal=True, backend=b,
                                     **({"interpret": True}
                                        if b == "pallas" else {}))
                for b in ("pallas", "ref")], dt)
    out, lse = tops.flash_attention_fwd(tq, tk, tv, causal=True)
    jo, jl = jops.flash_attention_fwd(jq, jk, jv, causal=True,
                                      backend="pallas", interpret=True)
    _held(out, [jo], dt)
    np.testing.assert_allclose(_np(lse), _np(jl), rtol=0, atol=1e-5)
    if qs > 1:
        wrong = tops.flash_attention(_wrong_scale(tq), tk, tv, causal=True)
        assert _err(wrong, jo, dt) > 1.0


@pytest.mark.parametrize("dt,qs", CASES)
def test_decode_attention_at_d112(dt, qs):
    """K4: 4 slots over a 40-cell dense cache, positions 0 (v[0]
    exactly), 39, 7, 20."""
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng, (4, 1, H, D), dt, qs)
    jk, tk = _pair(rng, (4, 40, KV, D), dt)
    jv, tv = _pair(rng, (4, 40, KV, D), dt)
    pos = np.array([0, 39, 7, 20], np.int32)
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(pos))
    jpos = jnp.asarray(pos)
    want = jops.decode_attention(jq, jk, jv, jpos, backend="pallas",
                                 interpret=True)
    _held(got, [want, jops.decode_attention(jq, jk, jv, jpos,
                                            backend="ref")], dt)
    np.testing.assert_allclose(_np(got[0, 0]),
                               _np(tv[0, 0].repeat_interleave(H, 0)),
                               rtol=1e-6, atol=1e-6)
    if qs > 1:
        wrong = tops.decode_attention(_wrong_scale(tq), tk, tv,
                                      torch.from_numpy(pos))
        assert _err(wrong, want, dt) > 1.0


def _tables(n, p_tab):
    """Sentinels everywhere but a ragged prefix of each of 3 rows."""
    tables = np.full((3, p_tab), n, np.int32)
    tables[0, :3] = [2, 7, 1]
    tables[1, :2] = [4, 9]
    tables[2, :1] = [11]
    return tables


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("dt,qs", CASES)
def test_paged_decode_attention_at_d112(dt, qs, c, quantized):
    """#8 and #8q (int8 pools of 112 bytes a row with per-cell scales):
    a decode column and a 5-column chunk, pages of 8, 4-page tables with
    sentinels."""
    n, page, p_tab = 12, 8, 4
    rng = np.random.default_rng(c + 10 * quantized)
    jq, tq = _pair(rng, (3, c, H, D), dt, qs)
    jk, tk = _pair(rng, (n, page, KV, D), "f32" if quantized else dt)
    jv, tv = _pair(rng, (n, page, KV, D), "f32" if quantized else dt)
    tables, pos = _tables(n, p_tab), np.array([17, 9, 3], np.int32)
    jt, tt_ = jnp.asarray(tables), torch.from_numpy(tables)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    kw, jkw = {}, {}
    if quantized:
        jk, jks = jquant.quantize_kv(jk)
        jv, jvs = jquant.quantize_kv(jv)
        tk, tks, tv, tvs = (torch.from_numpy(np.asarray(a).copy())
                            for a in (jk, jks, jv, jvs))
        assert tk.dtype == torch.int8 and tk.stride(-2) == D
        kw, jkw = dict(k_scale=tks, v_scale=tvs), dict(k_scale=jks,
                                                       v_scale=jvs)
    got = tops.paged_decode_attention(tq, tk, tv, tt_, tp, **kw)
    assert got.shape == (3, c, H, D) and got.dtype == tq.dtype
    want = jops.paged_decode_attention(jq, jk, jv, jt, jp, backend="pallas",
                                       interpret=True, **jkw)
    _held(got, [want, jops.paged_decode_attention(jq, jk, jv, jt, jp,
                                                  backend="ref", **jkw)], dt)
    if qs > 1:
        wrong = tops.paged_decode_attention(_wrong_scale(tq), tk, tv, tt_,
                                            tp, **kw)
        assert _err(wrong, want, dt) > 1.0


# ---------------------------------------------------------------------------
# a kimi smoke model at head_dim 112: the engines against the JAX engines
# ---------------------------------------------------------------------------

#: kimi-k2's smoke config widened to heads of 112: 896 = 8 x 112
OVER = dict(d_model=896, num_heads=8, num_kv_heads=1, num_layers=2,
            num_experts=8)


@functools.lru_cache(maxsize=None)
def _runtimes():
    """Both smoke configs at head_dim 112 with a 4+1d MetaTT q/v adapter
    (rank 4, 3 tasks, ``random_tt(0.3)``) made by the JAX package."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(KIMI), **OVER)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(KIMI), **OVER)
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim == D
    jrun, trun = _runs(cfg, jcfg, "4+1d")
    jspec, spec = JM.build_adapter_spec(jrun), TM.build_adapter_spec(trun)
    jp = JM.init_params(jcfg, jspec, KEY)
    jp["adapter"] = {"cores": jtt.random_tt(KEY, jspec.cfg.mode_sizes, 4,
                                            scale=0.3)}
    tp = from_jax_numpy(jax.device_get(jp), device="cpu")
    jrt = JRuntime.build("live", jp["base"], jspec, jp["adapter"],
                         jp["frozen"])
    trt = AdapterRuntime.build("live", tp["base"], spec, tp["adapter"],
                               tp["frozen"])
    return jcfg, jrt, cfg, trt


def _engines(**kw):
    jcfg, jrt, cfg, trt = _runtimes()
    sv = dict(BASE, **kw)
    return (JEngine(jcfg, jrt, serve=JServeConfig(**sv)),
            Engine(cfg, trt, serve=ServeConfig(**sv), device="cpu"))


def test_dense_engine_at_d112_token_identical_to_jax():
    """5 mixed-task requests through 2 dense slots: tokens, admission
    counters and KV bytes equal; the cache rows are 112 wide."""
    jeng, teng = _engines(cache_mode="dense")
    got = _serve(jeng, teng, _work("4+1d"), (
        "admitted", "evicted", "tokens_generated", "kv_bytes_peak"))
    assert teng.last_stats.kv_bytes_peak > 0
    assert [len(t) for t in got] == [5 + (i % 3) for i in range(5)]


def test_paged_engine_at_d112_token_identical_to_jax():
    """The paged engine with a 10-token shared prefix, cold then warm:
    tokens identical to the JAX paged engine's; prefix hits, COW, peak
    blocks, block bytes and peak KV bytes equal; no leaked block; every
    pool row holds 112 values."""
    jeng, teng = _engines()
    work = _work("4+1d", prefix=10)
    for _ in ("cold", "warm"):
        _serve(jeng, teng, work, PAGED_COUNTERS + ("block_bytes",
                                                   "kv_bytes_peak"))
    st = teng.last_stats
    assert st.prefix_hit_rate > 0 and st.cow_copies >= 1
    assert teng.leaked_blocks() == 0
    pools = [t for c in teng._paged_caches for t in c["self"].values()]
    assert pools and all(t.shape[-1] == D for t in pools)
    # block bytes: K and V, every layer, page x KV heads x 112 x 4 bytes
    cfg = _runtimes()[2]
    assert st.block_bytes == (2 * cfg.num_layers * BASE["page_size"]
                              * cfg.num_kv_heads * D * 4)


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


def test_cuda_wrappers_take_112_for_serving_and_refuse_it_for_training(
        monkeypatch):
    """The device checks of the CUDA wrappers (the card is replaced by a
    no-op device check so they run here): bf16 at 112 passes for K3 / #5,
    K4, #8 and #8q under the ``_d112`` counters, and for the backward (#6
    / #7) under theirs; 96 raises everywhere, and f32 at 112 raises for
    the forward and the backward. (The name is kept from when #6 / #7
    refused 112.)"""
    monkeypatch.setattr(_build, "check_device", lambda t: None)
    x = torch.zeros((1, 8, 2, D), dtype=torch.bfloat16)
    assert tfa._check_cuda((x, x, x), D, "k3") == "_d112"
    counts = kernels.launch_counts()
    for name in ("flash_attention_d112", "flash_attention_fwd_d112",
                 "decode_attention_d112", "paged_decode_attention_d112",
                 "paged_decode_attention_int8_d112",
                 "flash_attention_bwd_dq_d112",
                 "flash_attention_bwd_dkv_d112"):
        assert name in kernels.KERNELS and name in counts
    assert tfa._check_cuda((x,) * 5, D, "bwd",
                           dims=tfa.HEAD_DIMS_BWD) == "_d112"
    x96 = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16)
    for dims in (tfa.HEAD_DIMS, tfa.HEAD_DIMS_BWD):
        with pytest.raises(NotImplementedError):
            tfa._check_cuda((x96, x96, x96), 96, "d96", dims=dims)
    for dims in (tfa.HEAD_DIMS, tfa.HEAD_DIMS_BWD):
        with pytest.raises(NotImplementedError):
            tfa._check_cuda((x.float(),) * 3, D, "f32", dims=dims)
    assert tfa.tile_dim(D) == 128 and tfa.tile_dim(128) == 128
    assert tfa.tile_dim(64) == 64 and tfa.tile_dim(256) == 256
