#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed on its own lines:
  1. the card's name and power limit (nvidia-smi), then an nvcc build of
     every kernel under src/repro_torch/kernels/csrc;
  2. each kernel against its plain PyTorch version on the card, in bf16 at
     the serving path's full-width shapes, with the stated tolerance; the
     kernel's, the plain version's and one library call's times (the
     library call is a yardstick only: the port never calls it);
  3. the dense-cache serving engine on full-width stablelm-1.6b (random
     weights from a seeded generator, 4+1d MetaTT adapter over 3 tasks):
     8 mixed-task requests, with every kernel's launch count read around
     ``generate``; under the served adapter the kernel leg's prefill
     logits are held against the plain leg's distance from an f32 plain
     leg, and under a mild adapter the prefill logits and one 4-slot
     mixed-task decode step are held against the plain leg;
  4. one JSON line with every kernel's record.
The last line is ``{"ok": true, "device": {...}}``. Any failed check,
build or launch raises, and the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PEAK_BF16_FLOP_S = 989e12     # H100 SXM dense bf16 tensor cores
L2_BYTES = 50 * 2 ** 20
SEED = 0

# kernel -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "tt_linear": ("src/repro_torch/kernels/csrc/tt_linear.cu",
                  "src/repro/kernels/tt_linear.py:291"),
    "tt_linear_batched_a": ("src/repro_torch/kernels/csrc/tt_linear.cu",
                            "src/repro/kernels/tt_linear.py:156"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:112"),
    "decode_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:393"),
}
# |kernel - plain| <= ATOL + RTOL * |plain|, elementwise. Linears: one
# bf16 ulp (2^-7 relative) from a different f32 summation order.
# Attention: the kernel rounds unnormalised p (relative to its running
# max) to bf16 while the plain version rounds the normalised softmax, so
# the P·V inputs differ by up to a bf16 ulp each (the JAX package's own
# bf16 flash tolerance is 2e-2, tests/test_kernels.py).
TOL = {"tt_linear": (1e-2, 1e-2), "tt_linear_batched_a": (1e-2, 1e-2),
       "flash_attention": (2e-2, 2e-2), "decode_attention": (2e-2, 2e-2)}


def sh(cmd):
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def cuda_time_ms(fn, sets, iters=20):
    """Device ms per call: ``iters`` calls, cycling input sets so each
    call finds its operands cold in L2 (as a layer of the model does), are
    captured in one CUDA graph and the replay is timed with CUDA events —
    host launch overhead is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    return 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S), (
        "bytes" if nbytes / PEAK_BYTES_S >= flops / PEAK_BF16_FLOP_S
        else "operations")


def copies(make, nbytes):
    """Enough independent input sets to exceed 2x the L2 cache."""
    n = max(2, int(np.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [make() for _ in range(min(n, 64))]


def compare(name, got, want):
    import torch
    torch.cuda.synchronize()
    atol, rtol = TOL[name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def phase_kernels(dev):
    """Every kernel vs its plain version at the serving shapes (bf16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tt_linear as tl

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(bf)

    rows = []
    alpha = 4.0
    # K1: prefill q/v projections (M = prompt bucket)
    for m in (16, 64, 256):
        k = n = 2048
        r = 8

        def make():
            return (rn(m, k), rn(k, n, scale=k ** -0.5),
                    rn(k, r, scale=k ** -0.5), rn(r, n, scale=r ** -0.5))
        nbytes = 2 * (m * k + k * n + k * r + r * n + m * n)
        sets = copies(make, nbytes)
        x, w, a, b = sets[0]
        err = compare("tt_linear", tl.tt_linear(x, w, a, b, alpha),
                      tl.tt_linear_plain(x, w, a, b, alpha))
        flops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
        bms, by = bound_ms(nbytes, flops)
        rows.append(dict(
            name="tt_linear", shape=f"M={m} K={k} N={n} r={r}",
            main=m == 64,
            max_abs_err=err,
            ms=cuda_time_ms(lambda *s: tl.tt_linear(*s, alpha), sets),
            plain_ms=cuda_time_ms(
                lambda *s: tl.tt_linear_plain(*s, alpha), sets),
            library_ms=cuda_time_ms(
                lambda x, w, a, b: torch.matmul(x, w)
                + alpha * torch.matmul(torch.matmul(x, a), b), sets),
            bound_ms=bms, bound_by=by))
    # K2: decode q/v projections, 4 slots, task-routed A rows
    m, k, n, r = 4, 2048, 2048, 8

    def make2():
        return (rn(m, k), rn(k, n, scale=k ** -0.5),
                rn(m, k, r, scale=k ** -0.5), rn(r, n, scale=r ** -0.5))
    nbytes = 2 * (m * k + k * n + m * k * r + r * n + m * n)
    sets = copies(make2, nbytes)
    x, w, a, b = sets[0]
    err = compare("tt_linear_batched_a",
                  tl.tt_linear_batched_a(x, w, a, b, alpha),
                  tl.tt_linear_batched_a_plain(x, w, a, b, alpha))
    bms, by = bound_ms(nbytes, 2 * m * k * n + 2 * m * k * r + 2 * m * r * n)
    rows.append(dict(
        name="tt_linear_batched_a", shape=f"M={m} K={k} N={n} r={r}",
        main=True,
        max_abs_err=err,
        ms=cuda_time_ms(lambda *s: tl.tt_linear_batched_a(*s, alpha), sets),
        plain_ms=cuda_time_ms(
            lambda *s: tl.tt_linear_batched_a_plain(*s, alpha), sets),
        library_ms=cuda_time_ms(
            lambda x, w, a, b: torch.matmul(x, w) + alpha * torch.matmul(
                torch.bmm(x[:, None], a)[:, 0], b), sets),
        bound_ms=bms, bound_by=by))
    # K3: prefill attention, causal, T == S (bucketed prompt)
    for t, kvh in ((16, 32), (64, 32), (256, 32), (256, 8)):
        b_, h, d = 1, 32, 64

        def make3():
            return (rn(b_, t, h, d), rn(b_, t, kvh, d), rn(b_, t, kvh, d))
        nbytes = 2 * (2 * b_ * t * h * d + 2 * b_ * t * kvh * d)
        sets = copies(make3, nbytes)
        q, kk, vv = sets[0]
        err = compare("flash_attention", fa.flash_attention(q, kk, vv, True),
                      fa.flash_attention_plain(q, kk, vv, True))
        pairs = t * (t + 1) // 2
        bms, by = bound_ms(nbytes, 4 * b_ * h * d * pairs)
        g = h // kvh
        lib_sets = [(q.transpose(1, 2),
                     kk.repeat_interleave(g, 2).transpose(1, 2),
                     vv.repeat_interleave(g, 2).transpose(1, 2))
                    for q, kk, vv in sets]
        rows.append(dict(
            name="flash_attention",
            shape=f"B={b_} T=S={t} H={h} KV={kvh} d={d} causal",
            main=t == 64 and kvh == h,
            max_abs_err=err,
            ms=cuda_time_ms(lambda *s: fa.flash_attention(*s, True), sets),
            plain_ms=cuda_time_ms(
                lambda *s: fa.flash_attention_plain(*s, True), sets),
            library_ms=cuda_time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), lib_sets),
            bound_ms=bms, bound_by=by))
    # K4: decode attention, 4 slots at mixed positions of a 256-cell cache
    pos = torch.tensor([0, 37, 130, 255], dtype=torch.int32, device=dev)
    for kvh in (32, 8):
        b_, s_len, h, d = 4, 256, 32, 64

        def make4():
            return (rn(b_, h, d), rn(b_, s_len, kvh, d),
                    rn(b_, s_len, kvh, d), pos)
        cells = int((pos.clamp(max=s_len - 1) + 1).sum())
        nbytes = 2 * (2 * b_ * h * d + 2 * cells * kvh * d) + 4 * b_
        sets = copies(make4, nbytes)
        q, kk, vv, _ = sets[0]
        err = compare("decode_attention",
                      fa.decode_attention(q, kk, vv, pos),
                      fa.decode_attention_plain(q, kk, vv, pos))
        bms, by = bound_ms(nbytes, 4 * h * d * cells)
        g = h // kvh
        mask = (torch.arange(s_len, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        lib_sets = [(q[:, :, None], kk.repeat_interleave(g, 2).transpose(1, 2),
                     vv.repeat_interleave(g, 2).transpose(1, 2))
                    for q, kk, vv, _ in sets]
        rows.append(dict(
            name="decode_attention",
            shape=f"B={b_} S={s_len} H={h} KV={kvh} d={d} pos=0,37,130,255",
            main=kvh == h,
            max_abs_err=err,
            ms=cuda_time_ms(lambda *s: fa.decode_attention(*s), sets),
            plain_ms=cuda_time_ms(
                lambda *s: fa.decode_attention_plain(*s), sets),
            library_ms=cuda_time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), lib_sets),
            bound_ms=bms, bound_by=by))
    for r_ in rows:
        print(f"[kernel] {r_['name']:20s} {r_['shape']:44s} "
              f"err={r_['max_abs_err']:.3e} ms={r_['ms']:.4f} "
              f"plain_ms={r_['plain_ms']:.4f} "
              f"library_ms={r_['library_ms']:.4f} "
              f"bound_ms={r_['bound_ms']:.4f} ({r_['bound_by']})",
              flush=True)
    return rows


def logits_rel_err(eng, eng_ref, req):
    """max |kernel - plain| / max |plain| over one request's last-position
    prefill logits."""
    lg = eng.prefill_logits(req.prompt, req.task).float()
    lg_ref = eng_ref.prefill_logits(req.prompt, req.task).float()
    return float((lg - lg_ref).abs().max() / lg_ref.abs().max())


def tree_map(fn, tree):
    """``fn`` over every tensor leaf of a nested dict/list."""
    import torch
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def decode_step_rel_err(cfg, rt, reqs, cache_len, dev):
    """One decode step of ``len(reqs)`` slots, each at its own task and
    position, from the same prefilled caches through the kernel leg and
    the plain leg. Returns the largest over slots of max |kernel - plain|
    / max |plain| of the slot's logits row, and how many slots' argmax
    agree."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    base, bc, pl = rt.base, rt.broadcast, rt.per_layer
    n = len(reqs)
    caches = T.init_caches(cfg, n, cache_len, cfg.compute_dtype, device=dev)
    tok = torch.zeros((n, 1), dtype=torch.long, device=dev)
    pos = torch.zeros((n,), dtype=torch.long, device=dev)
    with torch.inference_mode():
        for slot, r in enumerate(reqs):
            out = T.forward(base, cfg, rt.spec, bc, pl,
                            torch.as_tensor(r.prompt, device=dev)[None],
                            task=r.task, device=dev)
            T.insert_cache_slot(caches, out.caches, slot)
            tok[slot, 0] = out.logits[0, -1].argmax()
            pos[slot] = len(r.prompt)
        task = torch.tensor([r.task for r in reqs], device=dev)
        kern, ref = (T.decode_step(base, cfg, rt.spec, bc, pl, tok,
                                   tree_map(torch.clone, caches), pos,
                                   task=task, policy=policy,
                                   device=dev)[0].float()
                     for policy in (dispatch.DEFAULT, dispatch.REF))
    rel = ((kern - ref).abs().amax(-1) / ref.abs().amax(-1)).max()
    return float(rel), int((kern.argmax(-1) == ref.argmax(-1)).sum())


def adapter_ratio(rt, spec, gen):
    """||α·(x·A)·B|| / ||x·W|| for layer 0's q projection, task 0, on a
    unit-normal x: how strong the adapter is against the frozen base."""
    import torch
    from repro_torch.peft import api as peft_api
    x = torch.randn((16, spec.cfg.d_in[0]), generator=gen,
                    device=gen.device)
    a, b, alpha = peft_api.lora_form_factors(
        spec, rt.broadcast, {"c": rt.per_layer["c"][0]}, "attn_q", task=0)
    base = x @ rt.base["blocks"][0]["mixer"]["wq"][0].float()
    return float((alpha * (x @ a) @ b).norm() / base.norm())


def device_share(eng, reqs):
    """Device busy share of a short generate under torch.profiler: the sum
    of kernel time on the card over the host wall time (the profiler's own
    host cost inflates the wall time, so the share is a lower bound), and
    the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:   # kernels / copies on the card
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not per_name:
        print("[profile] no device time in the trace: busy share not "
              "measured")
        return
    busy = sum(us for us, _ in per_name.values()) / 1e6
    print(f"[profile] generate of {len(reqs)} requests: wall {wall:.3f}s, "
          f"device busy {busy:.3f}s = {100 * busy / wall:.1f}% (profiled)")
    top = sorted(((us, n, k) for k, (us, n) in per_name.items()),
                 reverse=True)[:8]
    for us, n, key in top:
        print(f"[profile]   {us / 1e3:9.2f} ms  {n:6d}x  {key[:90]}")


def phase_serving(dev):
    """Dense-cache engine on full-width stablelm-1.6b, 8 mixed-task
    requests; kernel launches counted around ``generate`` only."""
    import torch
    from repro_torch import configs
    from repro_torch import kernels as K
    from repro_torch.config.base import KernelConfig, RunConfig, ServeConfig
    from repro_torch.core import tt as ttlib
    from repro_torch.models import model as M
    from repro_torch.serving import AdapterRuntime, Engine, Request

    cfg = configs.get_config("stablelm-1.6b")
    run = RunConfig(model=cfg, adapter_kind="metatt",
                    adapter_variant="4+1d", num_tasks=3, adapter_rank=8)
    spec = M.build_adapter_spec(run)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = M.init_params(cfg, spec, generator=gen, device=dev)
    params["adapter"] = {"cores": ttlib.random_tt(
        gen, spec.cfg.mode_sizes, 8, scale=0.5, device=dev)}
    rt = AdapterRuntime.build("live", params["base"], spec,
                              params["adapter"], params["frozen"])
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in M.tensors(params["base"]))
    print(f"[serve] stablelm-1.6b bf16: {nbytes / 1e9:.3f} GB of base "
          f"weights, init {time.perf_counter() - t0:.1f}s", flush=True)
    serve = ServeConfig(cache_mode="dense", max_batch=4, cache_len=256,
                        out_cap=32)
    eng = Engine(cfg, rt, serve=serve, device=dev)
    rng = np.random.RandomState(SEED)
    reqs = [Request(rng.randint(0, cfg.vocab_size, size=int(n)), 32,
                    task=i % 3)
            for i, n in enumerate(rng.randint(16, 97, size=8))]
    eng.generate(reqs[:2])                       # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    st = eng.last_stats
    for res in eng.last_results:
        if res.status != "FINISHED" or res.n_generated != 32:
            raise AssertionError(f"request ended {res.status} with "
                                 f"{res.n_generated} tokens")
    for o in outs:
        if not (0 <= int(o.min()) and int(o.max()) < cfg.vocab_size):
            raise AssertionError(f"token id outside the vocab: {o}")
    for name in K.KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched during generate")
    print(f"[serve] launches during generate: {json.dumps(launches)}")
    print(f"[serve] {st.requests} requests, {st.tokens_generated} tokens in "
          f"{st.wall_s:.3f}s = {st.tokens_per_s:.1f} tok/s; prefill "
          f"{1e3 * st.prefill_s / max(st.prefills, 1):.2f} ms/request; decode "
          f"{1e3 * st.decode_s / max(st.decode_steps, 1):.2f} ms/step over "
          f"{st.decode_steps} steps; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)

    device_share(eng, reqs[:4])

    # the plain-version leg on the same card and weights
    eng_ref = Engine(cfg, rt, serve=serve, kernels=KernelConfig(
        backend="ref"), device=dev)
    req = reqs[0]
    rel_served = logits_rel_err(eng, eng_ref, req)
    print(f"[serve] served adapter: adapter/base q-projection ratio "
          f"{adapter_ratio(rt, spec, gen):.3e}; prefill last-position "
          f"logits, kernel leg vs plain leg: max rel err {rel_served:.3e}")
    # witness for the served adapter: the plain leg in f32 on the same
    # weights. If bf16 rounding alone sends the model elsewhere, the plain
    # bf16 leg is as far from f32 as the kernel leg is; the kernel leg
    # must be no farther from f32 than twice the plain bf16 leg (+ 5%)
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    rt32 = AdapterRuntime.build(
        "live", tree_map(lambda t: t.float(), params["base"]), spec,
        params["adapter"], params["frozen"])
    eng32 = Engine(cfg32, rt32, serve=serve,
                   kernels=KernelConfig(backend="ref"), device=dev)
    plain_vs_f32 = logits_rel_err(eng_ref, eng32, req)
    kernel_vs_f32 = logits_rel_err(eng, eng32, req)
    print(f"[serve] served adapter vs the f32 plain leg: plain bf16 "
          f"{plain_vs_f32:.3e}, kernel bf16 {kernel_vs_f32:.3e} (limit "
          f"2 x plain + 5e-2 = {2 * plain_vs_f32 + 5e-2:.3e})")
    if not kernel_vs_f32 <= 2 * plain_vs_f32 + 5e-2:
        raise AssertionError("kernel leg farther from f32 than the plain "
                             f"bf16 leg: {kernel_vs_f32:.3e} vs "
                             f"{plain_vs_f32:.3e}")
    del eng32, rt32
    # the same base under a mild adapter (its output ~1e-1 of the base
    # projection, as a fine-tuned update is): the kernel leg must give
    # the plain leg's logits to within bf16 drift through 24 layers —
    # held to 5% of the largest logit, at prefill and at one decode step
    mild = AdapterRuntime.build("live", params["base"], spec, {
        "cores": ttlib.random_tt(gen, spec.cfg.mode_sizes, 8, scale=0.12,
                                 device=dev)}, params["frozen"])
    eng_mild = Engine(cfg, mild, serve=serve, device=dev)
    eng_mild_ref = Engine(cfg, mild, serve=serve,
                          kernels=KernelConfig(backend="ref"), device=dev)
    rel = logits_rel_err(eng_mild, eng_mild_ref, req)
    print(f"[serve] mild adapter (ratio {adapter_ratio(mild, spec, gen):.3e}"
          f"): prefill logits vs plain leg max rel err {rel:.3e} "
          "(limit 5e-2)")
    if not rel <= 5e-2:
        raise AssertionError(f"prefill logits differ from the plain leg: "
                             f"{rel:.3e}")
    rel_dec, same = decode_step_rel_err(cfg, mild, reqs[:4], serve.cache_len,
                                        dev)
    print(f"[serve] mild adapter, one decode step of 4 slots (tasks "
          f"{[r.task for r in reqs[:4]]}, positions "
          f"{[len(r.prompt) for r in reqs[:4]]}): logits vs plain leg max "
          f"rel err per slot {rel_dec:.3e} (limit 5e-2), argmax equal "
          f"{same}/4")
    if not rel_dec <= 5e-2:
        raise AssertionError(f"decode-step logits differ from the plain "
                             f"leg: {rel_dec:.3e}")
    # greedy agreement with the plain leg, reported, not asserted: bf16
    # argmax near-ties may flip, and one flip changes the rest of a request
    for label, a, b in (("served", eng, eng_ref),
                        ("mild", eng_mild, eng_mild_ref)):
        got, want = a.generate(reqs), b.generate(reqs)
        same = sum(int(x == y) for o, r in zip(got, want)
                   for x, y in zip(o.tolist(), r.tolist()))
        first = sum(int(o[0] == r[0]) for o, r in zip(got, want))
        print(f"[serve] {label} adapter: greedy tokens equal to the plain "
              f"leg {same}/{sum(len(o) for o in got)}, first tokens "
              f"{first}/{len(got)}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    print(sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0], flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all(force=True)
    print(f"[build] nvcc sm_90a: {', '.join(sorted(logs))} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name, path in sorted(logs.items()):
        for line in open(path).read().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    rows = phase_kernels(dev)
    launches = phase_serving(dev)

    records = []
    for name, (src, replaces) in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        main_row = next(r for r in mine if r["main"])
        records.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=max(
                r["max_abs_err"] for r in mine),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"]))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
