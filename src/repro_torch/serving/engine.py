"""Continuous-batching serving engine (counterpart of
``src/repro/serving/engine.py``), paged or dense KV cache, one device.

  * ``max_batch`` decode SLOTS step together; per-slot state lives in one
    set of device tensors, request metadata on the host.
  * PAGED KV CACHE (``ServeConfig(cache_mode="paged")``, the default):
    k/v live in flat pools of ``num_blocks × page_size`` cells per layer;
    each slot owns a row of the block table mapping its logical pages to
    physical blocks. A host ``BlockManager`` (free list, refcounts) owns
    the pools, and the ``Scheduler`` admits requests by FREE BLOCKS — the
    worst case of each request is reserved at admission, so the loop
    never allocates.
  * PREFIX SHARING: prompt pages are indexed in a hash-chained
    ``PrefixCache`` when a request ends; a later request with the same
    prompt prefix maps the cached blocks into its table instead of
    recomputing them. Divergence inside a shared partial page copies that
    block once at admission (copy-on-write, ``copy_cache_block``). Chains
    are keyed per task id on a task-routed runtime: any adapted matrix
    makes deep-layer KV task-dependent. The pools persist across
    ``generate`` calls, because the prefix cache indexes them.
  * IN-LOOP CHUNKED PREFILL: every step runs a fixed (B, prefill_chunk)
    token block through ``transformer.paged_step`` — prefilling slots
    consume up to ``prefill_chunk`` prompt tokens, decoding slots carry
    one sampled token and pad — so there is no separate prefill and no
    bucket ladder. Attention is kernel #8 (paged attention); with a
    task-routed adapter the (B, C > 1) adapted q/v run the batched einsum
    (the JAX package has no kernel for that shape either).
  * DENSE KV CACHE (``cache_mode="dense"``, the parity baseline): each
    slot owns a ``cache_len``-cell cache row; a request's prompt is
    right-padded to a power-of-two (or ``prompt_buckets``) bucket and
    prefilled (K1 for the adapted q/v projections, K3 for attention);
    decode steps run K2 for q/v and K4 for attention.
  * The loop runs until some slot's active flag changes; the host then
    EVICTS finished slots (paged: registers their prompt pages, returns
    the blocks) and ADMITS pending requests while the other slots keep
    their state. The JAX engine runs this loop as one jitted
    ``while_loop``; eager PyTorch reads the active flags back once per
    step (a CUDA graph of the step comes later).
  * TASK ROUTING: with a 4+1d adapter the (B,) slot task vector gathers
    per-row C[l, t_b, m] slices from the one shared tensor train, so one
    batch mixes tasks.
  * ADAPTER PAGING (``ServeConfig(registry=RegistryConfig(
    max_resident_tasks=K))``, both cache modes): the task axis on the
    device shrinks to a fixed K-slot pool; the full factors stay in
    pinned host memory and a host ``AdapterRegistry`` (task → slot, pins,
    LRU / FIFO eviction) faults a task's column into its slot with one
    in-place copy at admission. The slot task vector then carries
    POOL-SLOT indices (the per-row A that K2 / #10 read is gathered from
    the pool on the device), admission gates on a free or idle slot as it
    gates on blocks, and prefix-cache namespaces stay keyed on the TASK
    ID, so an evicted and re-admitted task still warm-hits its prompts.
  * NaN GUARD: a step whose logits row is non-finite stops that slot,
    keeps the tokens emitted before and ends the request FAILED (paged:
    its KV is not indexed for reuse).
  * LIFECYCLE: ``cancel(request_id)`` and ``Request.deadline_s`` end a
    request CANCELLED / TIMEOUT between steps, with what it emitted
    (paged: the prefix whose KV is computed is indexed, then the blocks
    return to the pool).
  * RECOMPUTE PREEMPTION (``ServeConfig.preempt_after``, paged): when the
    FIFO head has been blocked that many consecutive host-loop iterations,
    the youngest running request is stopped, its computed KV indexed as a
    prefix and its blocks returned, and it re-enters the queue right
    behind the head with prompt + generated tokens as its prompt; its
    output continues where it stopped (``RequestResult.preemptions``).
  * CHAOS (``generate(..., chaos=ChaosInjector(...))``,
    ``serving/chaos.py``): scripted cancels, forced allocation failures,
    failed adapter fault-ins (the admission unwinds) and NaN logits per
    request, with ``chaos.audit`` of the block, prefix and pin invariants
    after every host-loop iteration.
  * QUANTIZATION: ``KernelConfig.quant`` and ``ServeConfig.quant`` merge
    (int8 wins). weights=int8 packs the base's matmul leaves ONCE at
    construction (``kernels/quant.py``): adapted projections run the
    w8a16 kernels (#9 at dense prefill, #10 at dense decode; the paged
    (B, C > 1) block dequantizes and runs the batched einsum), unadapted
    ones dequantize W for a plain matmul. kv=int8 (paged mode only)
    stores int8 cells with per-cell f32 scale pools that ride the same
    block tables, prefix cache and copy-on-write; attention is #8q.

  * RUNTIMES: ``live`` (the TT contraction per step), ``lora`` (the
    middle cores pre-folded into A once; K1 / K2 on the same shapes as
    live), ``merged`` (ΔW folded into the base weights: no adapter
    kernel at all) and ``none``.
  * BASE SNAPSHOTS: ``save_base_snapshot`` / ``load_base_snapshot`` write
    and read the base the steps read (an int8 engine's packed leaves stay
    int8), so a restart skips re-quantizing.
  * SPECULATIVE DECODE (``ServeConfig.spec``, ``serving/speculative.py``):
    a drafter made of the leading ``draft_rank`` bond columns of the same
    adapter (live, lora and plain-lora runtimes; the other kinds keep
    their full-rank factors) over every ``draft_layer_stride``-th
    super-block proposes ``spec_k`` tokens a step against its own KV
    region (dense: its own slot caches, prefilled at admission; paged:
    parallel pools read through the SAME block tables, so prefix hits
    and copy-on-write cover it). Then one write-only drafter step, one
    verifier pass over [committed token, drafts] (dense: a (B, k+1)
    decode step, one K4 launch a column; paged: the (B, C) step, C >=
    k+1, through #8 / #8q), and the accept rule. Greedy tokens are the
    non-speculative engine's.

  * TENSOR PARALLELISM (``ServeConfig(mesh_shape=(1, tp))``,
    ``sharding/rules.py``): one process a rank over an initialised
    ``torch.distributed`` group of tp ranks (gloo on the CPU, NCCL on the
    cards). Every rank runs this engine over the whole weights with the
    same seed, so the host-side scheduler, block manager, prefix cache
    and sampling agree rank by rank; each rank's pools (and dense caches)
    hold its contiguous stripe of KV/tp kv-heads. The decode steps run
    inside the serve-TP context: attention slices the rank's head group
    and all-gathers the heads, the readout all-gathers vocab stripes of
    the logits, and ``row_parallel`` row-slices ``wo`` / ``wd`` with an
    all-reduce. The dense prefill runs whole on every rank and admission
    writes the rank's stripe. Tokens equal the single-device engine's.

Data replicas (a mesh data axis above 1), the router and disaggregated
prefill are not ported yet: ``ServeConfig`` raises
``NotImplementedError`` for them, and ``ChaosInjector(kill_replica_at=)``
raises too.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.config.base import (KernelConfig, ModelConfig, QuantConfig,
                                     ServeConfig)
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.kernels import quant as quant_lib
from repro_torch.models import transformer
from repro_torch.peft import api as peft_api
from repro_torch.serving import adapter_registry
from repro_torch.serving import chaos as chaos_lib
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving import speculative as spec_lib
from repro_torch.serving.adapter_registry import AdapterRegistry
from repro_torch.serving.adapter_runtime import AdapterRuntime
from repro_torch.serving.block_manager import BlockManager, PrefixCache
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.stats import EngineStats
from repro_torch.sharding import serve_cache_stripe, serve_tp


@dataclasses.dataclass
class Request:
    """One generation request. prompt: 1-D int token ids (list / numpy /
    tensor). deadline_s: wall-clock budget from ``generate`` entry.
    request_id: handle for ``Engine.cancel`` (default: batch index)."""
    prompt: Any
    max_new_tokens: int
    task: int = 0
    deadline_s: Optional[float] = None
    request_id: Optional[Any] = None


FINISHED = "FINISHED"
CANCELLED = "CANCELLED"
TIMEOUT = "TIMEOUT"
FAILED = "FAILED"


class RequestResult(NamedTuple):
    """Per-request outcome of one ``generate`` (``engine.last_results``)."""
    tokens: np.ndarray
    status: str
    n_generated: int
    preemptions: int = 0


def _prompt_array(prompt) -> np.ndarray:
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.cpu().numpy()
    return np.asarray(prompt, np.int64).reshape(-1)


@dataclasses.dataclass
class DecodeState:
    """Per-slot device state. ``out`` has one extra column that takes the
    writes of slots that emit nothing this step."""
    tok: torch.Tensor        # (B, 1) last sampled token
    pos: torch.Tensor        # (B,)   cache cell tok is written at
    remaining: torch.Tensor  # (B,)   tokens still to sample
    active: torch.Tensor     # (B,)   slot is mid-generation
    widx: torch.Tensor       # (B,)   next column of the output buffer
    out: torch.Tensor        # (B, out_cap + 1) generated tokens
    task: torch.Tensor       # (B,)   per-slot task id (registry: pool slot)
    failed: torch.Tensor     # (B,)   NaN guard tripped
    caches: list             # dense KV caches, batch axis = slots
    dcaches: Any = None      # the speculative drafter's caches


@dataclasses.dataclass
class PagedState:
    """Per-slot device state of the paged loop. A slot is PREFILLING
    (done < plen: a step consumes up to prefill_chunk prompt tokens) or
    DECODING (one sampled token a step), both in the same (B, C) step.
    The block tables are not here: they change only at admit / evict
    boundaries, so the host keeps them (``Engine._tables``) and uploads
    them once per loop call."""
    tok: torch.Tensor        # (B, 1) last sampled token
    prompt: torch.Tensor     # (B, Lp) prompt tokens, right-padded
    plen: torch.Tensor       # (B,)   prompt length
    done: torch.Tensor       # (B,)   tokens whose KV is in the pools
    remaining: torch.Tensor  # (B,)   tokens still to sample
    active: torch.Tensor     # (B,)   slot is mid-request
    widx: torch.Tensor       # (B,)   next column of the output buffer
    out: torch.Tensor        # (B, out_cap + 1) generated tokens
    task: torch.Tensor       # (B,)   per-slot task id (registry: pool slot)
    failed: torch.Tensor     # (B,)   NaN guard tripped
    caches: list             # paged pools, leaves (nb, N, page, KV, hd)
    dcaches: Any = None      # the speculative drafter's parallel pools


class Engine:
    """Continuous-batching engine over an ``AdapterRuntime``.

    ``serve`` picks the cache layout: "paged" (the default — block pools,
    prefix sharing, in-loop chunked prefill) or "dense" (the parity
    baseline). ``kernels`` picks the dispatch policy (default: the CUDA
    kernels); ``device`` is where the engine runs (default: the CUDA
    device — raising without one; ``device="cpu"`` runs the plain
    versions). The runtime's weights must already be on that device.
    """

    def __init__(self, model_cfg: ModelConfig, runtime: AdapterRuntime, *,
                 sampling: sampling_lib.SamplingConfig =
                 sampling_lib.SamplingConfig(),
                 seed: int = 0,
                 kernels: Optional[KernelConfig] = None,
                 serve: Optional[ServeConfig] = None,
                 device=None):
        transformer.check_supported(model_cfg)
        for mixer, _ in model_cfg.block_pattern:
            if mixer != "attn":
                raise NotImplementedError(
                    f"slot engine needs attention KV caches; mixer {mixer!r} "
                    "carries stateful caches that cannot be slot-inserted "
                    "or paged")
        if model_cfg.is_encdec:
            # as in JAX: whisper is served through transformer.forward /
            # decode_step, not the slot engine
            raise NotImplementedError("enc-dec serving is not slotted yet")
        if runtime.tasked and runtime.spec.adapts("moe_down"):
            # moe_down deltas apply over expert-sorted (E, C, ff) blocks
            # (models/moe.py), whose leading axis is experts: a
            # per-request (B,) task vector cannot index them
            raise NotImplementedError(
                "per-request task routing does not reach the expert-sorted "
                "moe_down path; serve this adapter with a scalar task "
                "(per-task engines) or drop moe_down from matrix_types")
        self.sv = (serve if serve is not None else ServeConfig()).validate()
        self.cfg = model_cfg
        self.rt = runtime
        # tensor-parallel serving: a mesh needs its process group, and the
        # sharded dims must split evenly (a rank slices contiguous head /
        # vocab groups); there is no unsharded fallback
        self._tp = self.sv.tp_size
        if self.sv.mesh_shape:
            _check_tp(model_cfg, self.sv)
        self.device = resolve_device(device)
        emb = runtime.base["embed"]["tok"]
        if emb.device.type != self.device.type:
            raise RuntimeError(f"runtime weights are on {emb.device}, the "
                               f"engine runs on {self.device}")
        self.policy = dispatch.resolve(kernels)
        if self.policy.require_cuda and self.device.type != "cuda":
            raise RuntimeError("KernelConfig(backend='cuda') needs a CUDA "
                               "device")
        # KernelConfig.quant and ServeConfig.quant merge (int8 wins); the
        # base is packed once here, the KV side sizes the paged pools
        kq = (kernels.quant if isinstance(kernels, KernelConfig)
              else QuantConfig())
        sq = self.sv.quant
        self.quant = QuantConfig(
            weights="int8" if "int8" in (kq.weights, sq.weights) else "none",
            kv="int8" if "int8" in (kq.kv, sq.kv) else "none",
            group_size=kq.group_size or sq.group_size).validate()
        self._kv_quant = self.quant.kv == "int8"
        if self._kv_quant and self.sv.cache_mode != "paged":
            raise ValueError(
                "kv=int8 quantization needs cache_mode='paged' (the int8 "
                "cells and their scale pools live in the paged block "
                "layout)")
        if self.sv.row_parallel and self.quant.group_size:
            # ServeConfig checks its own quant; the KernelConfig merge can
            # bring grouped scales back
            raise ValueError(
                "row_parallel is incompatible with grouped int8 scales "
                "(group_size > 0): scale groups tile the contraction axis "
                "the row slices cut; use per-channel group_size=0")
        self.max_batch = self.sv.max_batch
        self.paged = self.sv.cache_mode == "paged"
        self.cache_len = self.sv.cache_len
        self.out_cap = self.sv.out_cap
        self.prompt_buckets = tuple(sorted(self.sv.prompt_buckets))
        self.sampling = sampling.validate()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        base = runtime.base
        if self.quant.weights == "int8":
            base = quant_lib.quantize_base(
                base, group_size=self.quant.group_size)
        # adapter paging: with registry.max_resident_tasks = K the device
        # holds a zeroed K-slot pool instead of the whole task axis; the
        # full factors stay in (pinned) host memory and admission writes
        # a task's column into its slot on demand
        self.reg_cfg = self.sv.registry
        self._reg_on = self.reg_cfg.enabled
        if self._reg_on and not runtime.tasked:
            raise ValueError(
                f"RegistryConfig.max_resident_tasks="
                f"{self.reg_cfg.max_resident_tasks} needs a task-routed "
                "runtime (metatt 4+1d live / lora); untasked and merged "
                "runtimes have no per-task columns to page")
        per_layer = runtime.per_layer
        self._host_per_layer = None
        if self._reg_on:
            self._host_per_layer = adapter_registry.host_factors(per_layer)
            per_layer = adapter_registry.pool_factors(
                per_layer, self.reg_cfg.max_resident_tasks)
        self.registry = (AdapterRegistry(self.reg_cfg.max_resident_tasks,
                                         policy=self.reg_cfg.eviction)
                         if self._reg_on else None)
        self._weights = (base, runtime.broadcast, per_layer)
        self.spec = self.sv.spec
        self._spec_on = self.spec.enabled
        self._draft_weights = None
        self._host_draft_pl = None
        self._build_drafter()
        self._cancel_ids: set = set()
        self._chaos = None
        self._live = None       # the loop's bookkeeping, for chaos.audit
        self.last_stats = self._new_stats()
        self.last_results: List[RequestResult] = []
        if self.paged:
            self._init_paged()

    def _build_drafter(self) -> None:
        """The drafter's weights (``spec_lib.build_drafter``: views of the
        engine's weights) and super-block count. Under the registry the
        drafter's truncated columns page with their target columns: a
        host copy of the drafter's full factors and a K-slot pool of its
        own, written at the same slot by every fault-in (a new base keeps
        the pool, whose slots the registry holds loaded)."""
        old = self._draft_weights
        self._draft_weights = None
        self._nb_draft = self.cfg.num_super_blocks
        if self._spec_on:
            base, bc, pl = self._weights
            if self._reg_on:
                pl = self.rt.per_layer      # the full task axis
            dbase, dbc, dpl, self._nb_draft = spec_lib.build_drafter(
                self.spec, self.rt.spec.kind, base, bc, pl,
                len(self.cfg.block_pattern))
            if self._reg_on:
                if old is None:
                    self._host_draft_pl = adapter_registry.host_factors(dpl)
                    dpl = adapter_registry.pool_factors(
                        dpl, self.reg_cfg.max_resident_tasks)
                else:
                    dpl = old[2]
            self._draft_weights = (dbase, dbc, dpl)

    # ------------------------------------------------------------------
    # paged mode: host pools and device pools
    # ------------------------------------------------------------------

    def _init_paged(self) -> None:
        sv = self.sv
        self._chunk = min(sv.prefill_chunk, sv.cache_len)
        if self._spec_on:
            # the verifier scores [committed token, k drafts] in one (B, C)
            # pass (ServeConfig.validate keeps spec_k + 1 <= cache_len)
            self._chunk = max(self._chunk, self.spec.spec_k + 1)
        self._page = sv.page_size
        self._num_blocks = sv.resolved_num_blocks
        # table width: worst-case pages per request, plus sentinel columns
        # so pad-column writes past a request's allocation land out of
        # table instead of in a real page
        self._p_tab = (sv.pages_per_request
                       + max(1, -(-self._chunk // self._page)))
        self._lp = sv.cache_len + self._chunk   # prompt buffer width
        # any task-adapted matrix (q/v by default) perturbs the residual
        # stream, so layer >= 1 prefix KV is task-dependent: tasked
        # runtimes key prefix chains per task id
        self._kv_tasked = self.rt.tasked
        self._build_host_pools()
        self._tables = np.full((self.max_batch, self._p_tab),
                               self._num_blocks, np.int32)
        self._block_bytes = self._kv_bytes(self._page)
        if self._spec_on:
            # the drafter's parallel region: same blocks, 1/stride layers
            self._block_bytes += self._kv_bytes(
                self._page, num_super_blocks=self._nb_draft)
        # the pools persist ACROSS generate calls — the prefix cache
        # indexes into them, so warm requests reuse KV of earlier calls
        # (the drafter's too: prompt cells carry the drafter KV its sync
        # pass wrote)
        self._paged_caches = self._fresh_pools()
        self._draft_pools = (self._fresh_pools(self._nb_draft)
                             if self._spec_on else None)

    def _build_host_pools(self) -> None:
        """(Re)build the host-side admission machinery: block manager,
        prefix cache and scheduler."""
        self.bm = BlockManager(self._num_blocks, self._page)
        self.prefix = PrefixCache(self.bm) if self.sv.prefix_cache else None
        self.sched = Scheduler(self.bm, self.prefix, self.last_stats,
                               registry=self.registry)

    def _fresh_pools(self, num_super_blocks: Optional[int] = None) -> list:
        """Zero pools (this rank's kv-head stripe under TP);
        ``num_super_blocks`` sizes the drafter's region."""
        return transformer.init_paged_caches(
            self.cfg, self._num_blocks, self._page, self.cfg.compute_dtype,
            kv_quant=self._kv_quant, device=self.device,
            num_super_blocks=num_super_blocks, shards=self._tp)

    def _tp_ctx(self):
        """The serve-TP context the decode steps run in (a no-op without
        a mesh)."""
        if not self.sv.mesh_shape:
            return contextlib.nullcontext()
        return serve_tp(None, self._tp, self.sv.row_parallel)

    @property
    def base_weights(self):
        """The base tree the steps read: with weights=int8, the packed
        ``{"q8", "scale"}`` leaves."""
        return self._weights[0]

    def save_base_snapshot(self, path: str) -> str:
        """Snapshot the (possibly int8-quantized) serving base to one
        ``.npz``, so a restart loads packed weights instead of
        re-quantizing the fp base (``checkpoint/ckpt.py``)."""
        return ckpt_lib.save_base_snapshot(path, self._weights[0])

    def load_base_snapshot(self, path: str) -> None:
        """Replace the serving base with a snapshot saved by an engine of
        the same model / quant configuration (the current base is the
        structure, dtype and device template)."""
        base = ckpt_lib.load_base_snapshot(path, self._weights[0])
        self._weights = (base,) + self._weights[1:]
        self._build_drafter()

    def _new_stats(self, requests: int = 0) -> EngineStats:
        return EngineStats(
            cache_mode=self.sv.cache_mode, requests=requests,
            weights_dtype="int8" if self.quant.weights == "int8" else "fp",
            kv_dtype="int8" if self._kv_quant else "fp",
            max_resident_tasks=self.reg_cfg.max_resident_tasks,
            shards=self._tp)

    def _kv_bytes(self, tokens: int,
                  num_super_blocks: Optional[int] = None) -> int:
        """Device bytes of k + v for ``tokens`` cells across every layer
        (of ``num_super_blocks`` super-blocks: the drafter's region). An
        int8 cell costs kv_dim bytes plus one f32 scale per kv head."""
        nb = num_super_blocks or self.cfg.num_super_blocks
        if self._kv_quant:
            per_cell = self.cfg.kv_dim + 4 * self.cfg.num_kv_heads
        else:
            per_cell = self.cfg.kv_dim * torch.empty(
                (), dtype=self.cfg.compute_dtype).element_size()
        return 2 * nb * len(self.cfg.block_pattern) * tokens * per_cell

    def _reset_paged_pool(self) -> None:
        """Drop every block (and the prefix index) — used when a failed
        generate leaves slot refcounts or the pools inconsistent. The
        registry forgets every mapping and pin too: its slots fault in
        again when next used."""
        if self.registry is not None:
            self.registry.clear()
        self._build_host_pools()
        self._tables[:] = self._num_blocks
        self._paged_caches = self._fresh_pools()
        if self._spec_on:
            self._draft_pools = self._fresh_pools(self._nb_draft)

    def _adapter_fault_in(self, slot: int, task: int) -> None:
        """Write ``task``'s column from the host factors into pool slot
        ``slot`` — the device half of an adapter fault: one in-place copy
        a leaf (the live C column or the lora-form A slice, and under
        speculation the drafter's truncated column at the same slot),
        then the registry's confirmation. The copies queue on the current
        stream, before the steps that read the slot."""
        adapter_registry.scatter_slot(
            self._weights[2], slot,
            adapter_registry.task_slice(self._host_per_layer, task))
        if self._spec_on:
            adapter_registry.scatter_slot(
                self._draft_weights[2], slot,
                adapter_registry.task_slice(self._host_draft_pl, task))
        self.registry.mark_loaded(task)

    def leaked_blocks(self) -> int:
        """Paged mode, between ``generate`` calls: blocks neither free nor
        held by the prefix cache (0 unless a request's refs leaked)."""
        cached = self.prefix.cached_blocks if self.prefix is not None else 0
        return self._num_blocks - self.bm.free_blocks - cached

    # ------------------------------------------------------------------
    # requests
    # ------------------------------------------------------------------

    def _bucket(self, plen: int) -> int:
        for bkt in self.prompt_buckets:
            if bkt >= plen:
                return min(bkt, self.cache_len)
        n = 8              # next power of two keeps the shapes few
        while n < plen:
            n *= 2
        return min(n, self.cache_len)

    def _validate_request(self, req: Request):
        prompt = _prompt_array(req.prompt)
        plen = int(prompt.shape[0])
        if plen < 1:
            raise ValueError("empty prompt")
        if not 1 <= req.max_new_tokens <= self.out_cap:
            raise ValueError(
                f"max_new_tokens={req.max_new_tokens} not in [1, out_cap="
                f"{self.out_cap}]")
        if plen + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds cache_len={self.cache_len}")
        if self.paged:
            # reject what can NEVER be admitted: a request whose
            # worst-case page count exceeds the whole pool would
            # backpressure forever at the FIFO head (strictly >: an exact
            # fit drains the pool and admits)
            total = -(-(plen + req.max_new_tokens) // self._page)
            if total > self._num_blocks:
                raise ValueError(
                    f"request needs {total} KV pages "
                    f"(ceil(({plen}+{req.max_new_tokens})/{self._page})) "
                    f"but the pool holds only {self._num_blocks} blocks — "
                    "it could never be admitted (raise num_blocks or "
                    "split the request)")
        self.rt.check_task(req.task)
        return prompt, plen

    def cancel(self, request_id) -> None:
        """Queue ``request_id`` for cancellation: dropped at submission if
        not yet admitted, otherwise ended between decode steps with the
        tokens emitted so far (status CANCELLED)."""
        self._cancel_ids.add(request_id)

    # ------------------------------------------------------------------
    # device pieces
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, prompt: np.ndarray, task, weights=None):
        """prompt (P,) -> (last-position logits (V,), caches of the
        bucket-padded prompt, leaves (nb, 1, Pb, KV, hd)); ``weights``:
        (base, broadcast, per_layer), the target's by default."""
        plen = prompt.shape[0]
        padded = torch.zeros((1, self._bucket(plen)), dtype=torch.long,
                             device=self.device)
        padded[0, :plen] = torch.as_tensor(prompt, device=self.device)
        base, bc, pl = weights or self._weights
        out = transformer.forward(base, self.cfg, self.rt.spec, bc, pl,
                                  padded, task=task, policy=self.policy,
                                  return_caches=True, device=self.device)
        return out.logits[0, plen - 1], out.caches

    @torch.inference_mode()
    def prefill_logits(self, prompt, task: int = 0) -> torch.Tensor:
        """The last-position logits (V,) that a request's first token is
        sampled from (the engine's own bucketed prefill)."""
        prompt = _prompt_array(prompt)
        self.rt.check_task(task)
        if self.registry is None:
            return self._prefill(prompt, task if self.rt.tasked else None)[0]
        # a registry engine reads the pool: pin the task's slot for the
        # call (faulting its column in), then drop the pin
        acq = self.registry.acquire(task)
        if acq is None:
            raise RuntimeError("every adapter slot is pinned")
        try:
            if acq.fault:
                self._adapter_fault_in(acq.slot, task)
            return self._prefill(prompt, acq.slot)[0]
        finally:
            self.registry.release(task)

    def init_state(self) -> DecodeState:
        b = self.max_batch
        z = dict(dtype=torch.long, device=self.device)
        return DecodeState(
            tok=torch.zeros((b, 1), **z), pos=torch.zeros((b,), **z),
            remaining=torch.zeros((b,), **z),
            active=torch.zeros((b,), dtype=torch.bool, device=self.device),
            widx=torch.zeros((b,), **z),
            out=torch.zeros((b, self.out_cap + 1), **z),
            task=torch.zeros((b,), **z),
            failed=torch.zeros((b,), dtype=torch.bool, device=self.device),
            caches=transformer.init_caches(
                self.cfg, b, self.cache_len, self.cfg.compute_dtype,
                device=self.device, shards=self._tp),
            dcaches=transformer.init_caches(
                self.cfg, b, self.cache_len, self.cfg.compute_dtype,
                device=self.device, num_super_blocks=self._nb_draft,
                shards=self._tp)
            if self._spec_on else None)

    def _admit(self, s: DecodeState, slot: int, req: Request,
               gen: torch.Generator, task_ref: int) -> None:
        """Prefill ``req`` into ``slot`` and sample its first token (it
        counts toward the output). ``task_ref``: the index the adapter is
        gathered with — the request's pool slot under the registry, its
        task id otherwise."""
        prompt, plen = self._validate_request(req)
        task = task_ref if self.rt.tasked else None
        last, caches1 = self._prefill(prompt, task)
        t0 = sampling_lib.sample(last[None], gen, self.sampling)[0]
        # the prefill is whole on every rank: under TP the slot takes this
        # rank's kv-head stripe of it
        with self._tp_ctx():
            transformer.insert_cache_slot(s.caches,
                                          serve_cache_stripe(caches1), slot)
        if self._spec_on:   # the drafter prefills the same prompt
            _, dcaches1 = self._prefill(prompt, task, self._draft_weights)
            with self._tp_ctx():
                transformer.insert_cache_slot(
                    s.dcaches, serve_cache_stripe(dcaches1), slot)
        n_new = int(req.max_new_tokens)
        s.tok[slot, 0] = t0
        s.pos[slot] = plen
        s.remaining[slot] = n_new - 1
        s.active[slot] = n_new > 1
        s.widx[slot] = 1
        s.out[slot] = 0
        s.out[slot, 0] = t0
        s.task[slot] = task_ref
        s.failed[slot] = False

    def _step(self, s: DecodeState, nan_at: torch.Tensor,
              gen: torch.Generator) -> None:
        """One decode step of every slot (inactive slots compute and
        discard), updating ``s`` in place."""
        base, bc, pl = self._weights
        task = s.task if self.rt.tasked else None
        logits, _ = transformer.decode_step(
            base, self.cfg, self.rt.spec, bc, pl, s.tok, s.caches, s.pos,
            task=task, policy=self.policy, device=self.device)
        # NaN guard: poison injected rows, then fail any row whose logits
        # are non-finite instead of sampling from them
        inject = s.active & (nan_at >= 0) & (s.widx >= nan_at)
        logits = torch.where(inject[:, None],
                             torch.full_like(logits, float("nan")), logits)
        finite = torch.isfinite(logits).all(dim=-1)
        bad = s.active & ~finite
        # rows that emit nothing still get a draw: give non-finite ones
        # zeros so a categorical draw stays valid (the token is dropped)
        logits = torch.where(finite[:, None], logits,
                             torch.zeros_like(logits))
        pm = (sampling_lib.history_mask(s.out[:, :self.out_cap], s.widx,
                                        self.cfg.padded_vocab)
              if self.sampling.repetition_penalty != 1.0 else None)
        nxt = sampling_lib.sample(logits, gen, self.sampling,
                                  penalty_mask=pm)
        emit = s.active & ~bad
        col = torch.where(emit, s.widx, torch.full_like(s.widx,
                                                        self.out_cap))
        s.out.scatter_(1, col[:, None], nxt[:, None])
        adv = emit.long()
        s.tok.copy_(torch.where(emit[:, None], nxt[:, None], s.tok))
        s.active &= (s.remaining > 1) & ~bad
        s.pos += adv
        s.remaining -= adv
        s.widx += adv
        s.failed |= bad

    # ------------------------------------------------------------------
    # speculative decode: pieces shared by both cache modes
    # ------------------------------------------------------------------

    def _propose(self, lg: torch.Tensor, mask, gen: torch.Generator):
        """One drafter proposal from logits (B, V): the token and, under a
        sampling method, the exact distribution q it was drawn from (the
        rejection rule needs it; greedy proposes the argmax)."""
        if self.sampling.method == "greedy":
            return torch.argmax(sampling_lib.process_logits(
                lg, self.sampling, penalty_mask=mask), dim=-1), None
        q = sampling_lib.token_probs(lg, self.sampling, penalty_mask=mask)
        return torch.multinomial(q, 1, generator=gen)[:, 0], q

    def _spec_accept(self, L: torch.Tensor, draft: torch.Tensor, q, base_mask,
                     gen: torch.Generator):
        """Accept / reject ``draft`` (B, k) against the verifier's logits
        L (B, k+1, V): greedy keeps the longest argmax-matching prefix plus
        the verifier's own next token; sampling runs rejection sampling
        against the exact per-column target distributions. The per-column
        repetition-penalty masks add the in-chunk draft prefix to the
        history, as sequential decode would."""
        col_masks = spec_lib.column_penalty_masks(base_mask, draft,
                                                  L.shape[-1])
        if self.sampling.method == "greedy":
            g = torch.argmax(sampling_lib.process_logits(
                L, self.sampling, penalty_mask=col_masks), dim=-1)
            return spec_lib.greedy_verify(draft, g)
        p = sampling_lib.token_probs(L, self.sampling,
                                     penalty_mask=col_masks)
        return spec_lib.rejection_verify(gen, draft, q, p)

    def _draft(self, s, gen: torch.Generator, base_mask, run_step):
        """k drafter proposals and one write-only step that lands the last
        draft's KV in the drafter's region (the next round's first
        drafter step attends it when every draft is accepted).
        ``run_step(tok (B, 1), j)`` runs drafter step j and returns its
        logits. Returns (drafts (B, k), q (B, k, V) or None)."""
        v = self.cfg.padded_vocab
        tok_j, mask_j = s.tok, base_mask
        drafts, qs = [], []
        for j in range(self.spec.spec_k + 1):
            lg = run_step(tok_j, j)
            if j == self.spec.spec_k:
                break
            d_j, q_j = self._propose(lg, mask_j, gen)
            drafts.append(d_j)
            if q_j is not None:
                qs.append(q_j)
            if base_mask is not None:
                mask_j = mask_j | torch.nn.functional.one_hot(
                    d_j, v).bool()
            tok_j = d_j[:, None]
        return (torch.stack(drafts, dim=1),
                torch.stack(qs, dim=1) if qs else None)

    def _commit(self, s, em: torch.Tensor, m: torch.Tensor) -> None:
        """Write the first m[b] tokens of em (B, k+1) into row b's output
        and make the last of them the row's next input token."""
        cols = torch.arange(em.shape[1], device=self.device)[None, :]
        outcol = torch.where(cols < m[:, None], s.widx[:, None] + cols,
                             torch.full_like(cols, self.out_cap))
        s.out.scatter_(1, outcol, em)
        last = torch.gather(em, 1, (m - 1).clamp(min=0)[:, None])
        s.tok.copy_(torch.where((m > 0)[:, None], last, s.tok))

    def _spec_step(self, s: DecodeState, nan_at: torch.Tensor,
                   gen: torch.Generator) -> None:
        """One speculative step of every dense slot: k drafter decode
        steps (+ one write-only), one (B, k+1) verifier decode step over
        [committed token, drafts] (one K4 launch a column), then the
        accept rule; a slot commits up to k + 1 tokens."""
        k = self.spec.spec_k
        base, bc, pl = self._weights
        dbase, dbc, dpl = self._draft_weights
        task = s.task if self.rt.tasked else None
        base_mask = (sampling_lib.history_mask(
            s.out[:, :self.out_cap], s.widx, self.cfg.padded_vocab)
            if self.sampling.repetition_penalty != 1.0 else None)

        def drafter(tok_j, j):
            return transformer.decode_step(
                dbase, self.cfg, self.rt.spec, dbc, dpl, tok_j, s.dcaches,
                s.pos + j, task=task, policy=self.policy,
                device=self.device)[0]
        d, q = self._draft(s, gen, base_mask, drafter)
        L, _ = transformer.decode_step(
            base, self.cfg, self.rt.spec, bc, pl,
            torch.cat([s.tok, d], dim=1), s.caches, s.pos, task=task,
            policy=self.policy, device=self.device, all_logits=True)
        # NaN guard over the verifier's logits: a bad row commits nothing
        inject = s.active & (nan_at >= 0) & (s.widx >= nan_at)
        L = torch.where(inject[:, None, None],
                        torch.full_like(L, float("nan")), L)
        finite = torch.isfinite(L).all(dim=-1).all(dim=-1)
        bad = s.active & ~finite
        L = torch.where(finite[:, None, None], L, torch.zeros_like(L))
        emitted, n = self._spec_accept(L, d, q, base_mask, gen)
        m = torch.where(s.active & ~bad, torch.minimum(n + 1, s.remaining),
                        torch.zeros_like(n))
        self._commit(s, emitted, m)
        self._spec_counts += torch.stack([
            k * s.active.sum(), torch.where(s.active, n, 0).sum()])
        s.active &= (s.remaining > m) & ~bad
        s.pos += m
        s.remaining -= m
        s.widx += m
        s.failed |= bad

    def _decode(self, s: DecodeState, nan_at: torch.Tensor,
                gen: torch.Generator) -> int:
        """Step every slot until some slot's active flag changes (the JAX
        engine's while_loop); one host read of the flags per step."""
        active0 = s.active.clone()
        step = self._spec_step if self._spec_on else self._step
        steps = 0
        while True:
            with self._tp_ctx():
                step(s, nan_at, gen)
            steps += 1
            if not bool((s.active.any()
                         & (s.active == active0).all()).item()):
                return steps

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def generate(self, requests: Sequence[Request], *,
                 generator: Optional[torch.Generator] = None,
                 chaos: Optional[chaos_lib.ChaosInjector] = None
                 ) -> List[np.ndarray]:
        """Serve ``requests`` through the slots; returns per request the
        generated token ids (length max_new_tokens unless the request was
        cancelled, timed out or failed). Fills ``last_stats`` and
        ``last_results`` (tokens, terminal status, preemption count).
        Sampling draws from ``generator`` (default: the engine's own,
        seeded at construction). ``chaos``: an optional
        ``serving/chaos.py::ChaosInjector`` driving seeded fault injection
        (scripted cancels, forced allocation and fault-in failures, NaN
        logits per request) with an invariant audit after every host-loop
        iteration."""
        for req in requests:
            self._validate_request(req)     # fail fast, before any work
        gen = generator if generator is not None else self.generator
        st = self.last_stats = self._new_stats(len(requests))
        self._rids = [req.request_id if req.request_id is not None
                      else idx for idx, req in enumerate(requests)]
        t0 = time.perf_counter()
        self._abs_deadline = [None if req.deadline_s is None
                              else t0 + req.deadline_s for req in requests]
        self._status = {}
        self._req_preempts = {}
        self._chaos = chaos
        # drafted, accepted: device counters, read once at the end
        self._spec_counts = torch.zeros(2, dtype=torch.long,
                                        device=self.device)
        try:
            if self.paged:
                results = self._generate_paged(requests, gen)
            else:
                results = self._generate_dense(requests, gen)
        finally:
            self._chaos = None
            self._live = None
            self._cancel_ids.clear()
        st.wall_s = time.perf_counter() - t0
        st.tokens_generated = sum(len(r) for r in results)
        if self._spec_on:
            st.spec_k = self.spec.spec_k
            st.spec_steps = st.decode_steps
            st.draft_tokens, st.accepted_tokens = (
                int(v) for v in self._spec_counts.tolist())
        self.last_results = [
            RequestResult(tokens=r, status=self._status.get(i, FINISHED),
                          n_generated=len(r),
                          preemptions=self._req_preempts.get(i, 0))
            for i, r in enumerate(results)]
        return results

    def _abort_status(self, idx: int) -> Optional[str]:
        if self._rids[idx] in self._cancel_ids:
            return CANCELLED
        dl = self._abs_deadline[idx]
        if dl is not None and time.perf_counter() >= dl:
            return TIMEOUT
        return None

    def _end(self, idx: int, status: str) -> None:
        self._status[idx] = status
        if status == CANCELLED:
            self.last_stats.cancelled += 1
        else:
            self.last_stats.timeouts += 1

    def _chaos_tick(self, step: int) -> None:
        """The chaos schedule's events for host-loop iteration ``step``:
        scripted cancels join the cancel set."""
        if self._chaos is not None:
            self._cancel_ids.update(self._chaos.tick(step)["cancels"])

    def _nan_threshold(self, idx: int) -> int:
        """The NaN-injection threshold of request ``idx`` (-1: never)."""
        return (self._chaos.nan_for(self._rids[idx])
                if self._chaos is not None else -1)

    def _audit(self) -> None:
        if self._chaos is not None and self._chaos.audit_every_step:
            chaos_lib.audit(self)
            self._chaos.audits += 1

    def _generate_dense(self, requests, gen) -> List[np.ndarray]:
        st = self.last_stats
        st.page_size = self.cache_len
        st.num_blocks = self.max_batch
        st.block_bytes = self._kv_bytes(self.cache_len)
        if self._spec_on:
            st.block_bytes += self._kv_bytes(
                self.cache_len, num_super_blocks=self._nb_draft)
        st.kv_blocks_peak = self.max_batch  # dense reserves every slot
        s = self.init_state()
        try:
            return self._dense_loop(s, requests, gen)
        except BaseException:
            if self.registry is not None:
                self.registry.clear()   # the slots' pins are gone
            raise

    def _dense_loop(self, s: DecodeState, requests, gen) -> List[np.ndarray]:
        """Host half of dense serving: each iteration runs the chaos
        events, the cancel / deadline sweep, admission into free slots
        (with the registry: gated on an adapter slot, faulting the task's
        column in), one loop call until some slot's flag changes, and the
        harvest of finished slots."""
        st = self.last_stats
        reg = self.registry
        pending = collections.deque(enumerate(requests))
        results: List[Optional[np.ndarray]] = [None] * len(requests)
        # one dict a busy slot: the request index and its task id
        meta: List[Optional[dict]] = [None] * self.max_batch
        nan_at = torch.full((self.max_batch,), -1, dtype=torch.long,
                            device=self.device)
        self._live = dict(meta=meta)

        def harvest(slot: int) -> np.ndarray:
            w = int(s.widx[slot])
            return s.out[slot, :w].cpu().numpy().astype(np.int32)

        def free_slot(slot: int) -> None:
            if reg is not None:
                reg.release(meta[slot]["task"])
            meta[slot] = None
            nan_at[slot] = -1
            st.evicted += 1

        hstep = 0
        while pending or any(m is not None for m in meta):
            self._chaos_tick(hstep)
            hstep += 1
            # cancels and deadlines, queued and in flight
            keep = collections.deque()
            for idx, req in pending:
                stt = self._abort_status(idx)
                if stt is None:
                    keep.append((idx, req))
                else:
                    results[idx] = np.zeros((0,), np.int32)
                    self._end(idx, stt)
            pending = keep
            for slot, m in enumerate(meta):
                if m is None:
                    continue
                stt = self._abort_status(m["idx"])
                if stt is None:
                    continue
                results[m["idx"]] = harvest(slot)
                self._end(m["idx"], stt)
                s.active[slot] = False
                s.remaining[slot] = 0
                free_slot(slot)
            # admit pending requests into free slots; with the registry a
            # head whose task gets no pool slot waits for a harvest to
            # unpin one (in-flight slots guarantee progress)
            t_adm = time.perf_counter()
            admitted = 0
            for slot in range(self.max_batch):
                if meta[slot] is not None or not pending:
                    continue
                idx, req = pending[0]
                task_ref = int(req.task)
                if reg is not None:
                    acq = reg.acquire(int(req.task))
                    if acq is None:
                        st.adapter_waits += 1
                        st.backpressure_waits += 1
                        break
                    if (acq.fault and self._chaos is not None
                            and self._chaos.fail_scatter()):
                        # injected fault-in failure: roll the pin back;
                        # the slot stays mapped-but-UNLOADED and the
                        # retry faults again
                        reg.release(int(req.task))
                        st.backpressure_waits += 1
                        break
                    if acq.fault:
                        st.adapter_faults += 1
                        if acq.evicted is not None:
                            st.adapter_evictions += 1
                        self._adapter_fault_in(acq.slot, int(req.task))
                    else:
                        st.adapter_hits += 1
                    task_ref = acq.slot
                pending.popleft()
                self._admit(s, slot, req, gen, task_ref)
                meta[slot] = dict(idx=idx, task=int(req.task))
                nan_at[slot] = self._nan_threshold(idx)
                admitted += 1
            if admitted:
                self._sync()
                st.admitted += admitted
                st.prefills += admitted
                st.prefill_s += time.perf_counter() - t_adm
            # decode every active slot until one's flag changes
            if bool(s.active.any()):
                t_dec = time.perf_counter()
                st.decode_steps += self._decode(s, nan_at, gen)
                st.decode_calls += 1
                st.decode_s += time.perf_counter() - t_dec
            # evict finished slots (also catches max_new_tokens == 1)
            active = s.active.cpu().numpy()
            failed = s.failed.cpu().numpy()
            for slot, m in enumerate(meta):
                if m is not None and not active[slot]:
                    results[m["idx"]] = harvest(slot)
                    if failed[slot]:
                        self._status[m["idx"]] = FAILED
                        st.failed_requests += 1
                        st.numerics_faults += 1
                    free_slot(slot)
            self._audit()
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # paged mode: device pieces
    # ------------------------------------------------------------------

    def init_paged_state(self) -> PagedState:
        """Fresh per-slot state over the engine's PERSISTENT pools."""
        b = self.max_batch
        z = dict(dtype=torch.long, device=self.device)
        return PagedState(
            tok=torch.zeros((b, 1), **z),
            prompt=torch.zeros((b, self._lp), **z),
            plen=torch.zeros((b,), **z), done=torch.zeros((b,), **z),
            remaining=torch.zeros((b,), **z),
            active=torch.zeros((b,), dtype=torch.bool, device=self.device),
            widx=torch.zeros((b,), **z),
            out=torch.zeros((b, self.out_cap + 1), **z),
            task=torch.zeros((b,), **z),
            failed=torch.zeros((b,), dtype=torch.bool, device=self.device),
            caches=self._paged_caches, dcaches=self._draft_pools)

    def _paged_admit(self, s: PagedState, slot: int, prompt: np.ndarray,
                     done0: int, n_new: int, task: int) -> None:
        """Place a request into ``slot``. No prefill here: the loop's
        chunked prefill consumes the prompt from ``done0`` on (tokens
        [0, done0) came from the prefix cache; the scheduler keeps done0
        <= plen - 1, so the last prompt token always runs through the
        model for its logits)."""
        plen = int(prompt.shape[0])
        s.prompt[slot] = 0
        s.prompt[slot, :plen] = torch.as_tensor(prompt, device=self.device)
        s.plen[slot] = plen
        s.done[slot] = done0
        s.remaining[slot] = n_new
        s.active[slot] = True
        s.widx[slot] = 0
        s.out[slot] = 0
        s.tok[slot, 0] = 0
        s.task[slot] = task
        s.failed[slot] = False

    def _paged_step(self, s: PagedState, tables: torch.Tensor,
                    nan_at: torch.Tensor, gen: torch.Generator) -> None:
        """One (B, C) step co-batching chunked prefill and decode, updating
        ``s`` and the pools in place: prefilling slots consume up to C
        prompt tokens, decoding slots one sampled token (pad columns'
        cache writes are overwritten by the step that owns those
        positions; sentinel table entries drop writes past a request's
        allocation)."""
        c = self._chunk
        cols = torch.arange(c, device=self.device)
        is_pf = s.done < s.plen
        start = torch.where(is_pf, s.done, torch.zeros_like(s.done))
        chunk = torch.gather(s.prompt, 1, start[:, None] + cols[None])
        ntok = torch.where(is_pf, (s.plen - s.done).clamp(max=c),
                           torch.ones_like(s.done))
        dec = torch.where(cols[None] == 0, s.tok, torch.zeros_like(chunk))
        toks = torch.where(is_pf[:, None], chunk, dec)
        base, bc, pl = self._weights
        task = s.task if self.rt.tasked else None
        logits, _ = transformer.paged_step(
            base, self.cfg, self.rt.spec, bc, pl, toks, s.caches, tables,
            s.done, ntok - 1, task=task, policy=self.policy,
            device=self.device)
        # NaN guard: poison injected rows, then fail any row whose logits
        # are non-finite instead of sampling from them
        inject = s.active & (nan_at >= 0) & (s.widx >= nan_at)
        logits = torch.where(inject[:, None],
                             torch.full_like(logits, float("nan")), logits)
        finite = torch.isfinite(logits).all(dim=-1)
        bad = s.active & ~finite
        logits = torch.where(finite[:, None], logits,
                             torch.zeros_like(logits))
        pm = (sampling_lib.history_mask(s.out[:, :self.out_cap], s.widx,
                                        self.cfg.padded_vocab)
              if self.sampling.repetition_penalty != 1.0 else None)
        nxt = sampling_lib.sample(logits, gen, self.sampling,
                                  penalty_mask=pm)
        new_done = s.done + ntok
        # a slot emits a token when its step reached the last prompt
        # position (prefill -> first token) or is decoding
        produced = s.active & (new_done >= s.plen) & ~bad
        col = torch.where(produced, s.widx,
                          torch.full_like(s.widx, self.out_cap))
        s.out.scatter_(1, col[:, None], nxt[:, None])
        adv = produced.long()
        s.tok.copy_(torch.where(produced[:, None], nxt[:, None], s.tok))
        s.active &= ((s.remaining > 1) | ~produced) & ~bad
        s.remaining -= adv
        s.widx += adv
        s.done.copy_(new_done)
        s.failed |= bad

    def _paged_spec_step(self, s: PagedState, tables: torch.Tensor,
                         nan_at: torch.Tensor, gen: torch.Generator) -> None:
        """One speculative (B, C) step: decoding rows commit up to k + 1
        tokens, prefilling rows consume a prompt chunk as in
        ``_paged_step``. The drafter runs k + 1 single-token steps over
        its parallel pools (prefilling rows write out of table: dropped),
        then, when a row is prefilling, a sync pass feeds the prompt chunk
        through the drafter (decoding rows write out of table); the
        verifier is the (B, C) step over the prompt chunk or [committed
        token, drafts], through #8 / #8q."""
        c, k = self._chunk, self.spec.spec_k
        cols = torch.arange(c, device=self.device)
        is_pf = s.done < s.plen
        start = torch.where(is_pf, s.done, torch.zeros_like(s.done))
        chunk = torch.gather(s.prompt, 1, start[:, None] + cols[None])
        ntok_pf = (s.plen - s.done).clamp(max=c)
        base, bc, pl = self._weights
        dbase, dbc, dpl = self._draft_weights
        task = s.task if self.rt.tasked else None
        zero = torch.zeros_like(s.done)
        # a position past the table routes a row's writes to the sentinel
        oob = torch.full_like(s.done, self._p_tab * self._page)
        base_mask = (sampling_lib.history_mask(
            s.out[:, :self.out_cap], s.widx, self.cfg.padded_vocab)
            if self.sampling.repetition_penalty != 1.0 else None)

        def drafter(tok_j, j):
            return transformer.paged_step(
                dbase, self.cfg, self.rt.spec, dbc, dpl, tok_j, s.dcaches,
                tables, torch.where(is_pf, oob, s.done + j), zero,
                task=task, policy=self.policy, device=self.device)[0]
        d, q = self._draft(s, gen, base_mask, drafter)
        dec_pad = torch.where(cols[None] == 0, s.tok, torch.zeros_like(chunk))
        if bool(is_pf.any()):
            transformer.paged_step(
                dbase, self.cfg, self.rt.spec, dbc, dpl,
                torch.where(is_pf[:, None], chunk, dec_pad), s.dcaches,
                tables, torch.where(is_pf, s.done, oob), zero, task=task,
                policy=self.policy, device=self.device)
        dv = torch.nn.functional.pad(torch.cat([s.tok, d], dim=1),
                                     (0, c - (k + 1)))
        L, _ = transformer.paged_step(
            base, self.cfg, self.rt.spec, bc, pl,
            torch.where(is_pf[:, None], chunk, dv), s.caches, tables,
            s.done, zero, task=task, policy=self.policy, device=self.device,
            all_logits=True)
        # NaN guard: the verifier's columns for decoding rows, the last
        # prompt column for prefilling rows
        inject = s.active & (nan_at >= 0) & (s.widx >= nan_at)
        L = torch.where(inject[:, None, None],
                        torch.full_like(L, float("nan")), L)
        rows = torch.arange(self.max_batch, device=self.device)
        l_sel = L[rows, torch.where(is_pf, ntok_pf - 1, zero).clamp(0, c - 1)]
        fin_pf = torch.isfinite(l_sel).all(dim=-1)
        fin_dec = torch.isfinite(L[:, :k + 1]).all(dim=-1).all(dim=-1)
        bad = s.active & ~torch.where(is_pf, fin_pf, fin_dec)
        l_sel = torch.where(fin_pf[:, None], l_sel, torch.zeros_like(l_sel))
        lv = L[:, :k + 1]
        lv = torch.where(fin_dec[:, None, None], lv, torch.zeros_like(lv))
        nxt_pf = sampling_lib.sample(l_sel, gen, self.sampling,
                                     penalty_mask=base_mask)
        emitted, n = self._spec_accept(lv, d, q, base_mask, gen)
        new_done_pf = s.done + ntok_pf
        produced_pf = s.active & (new_done_pf >= s.plen)
        m = torch.where(is_pf, produced_pf.long(),
                        torch.where(s.active,
                                    torch.minimum(n + 1, s.remaining), zero))
        m = torch.where(bad, zero, m)     # a failing row commits nothing
        em = torch.where(is_pf[:, None], nxt_pf[:, None].expand_as(emitted),
                         emitted)
        self._commit(s, em, m)
        dec_act = s.active & ~is_pf
        self._spec_counts += torch.stack([
            k * dec_act.sum(), torch.where(dec_act, n, 0).sum()])
        s.active &= ((s.remaining > m) | (m == 0)) & ~bad
        s.remaining -= m
        s.widx += m
        s.done.copy_(torch.where(is_pf, new_done_pf, s.done + m))
        s.failed |= bad

    def _paged_decode(self, s: PagedState, nan_at: torch.Tensor,
                      gen: torch.Generator) -> int:
        """Step every slot until some slot's active flag changes (the JAX
        engine's while_loop); the block tables go up once, the flags come
        back once per step."""
        tables = torch.as_tensor(self._tables, device=self.device)
        active0 = s.active.clone()
        step = self._paged_spec_step if self._spec_on else self._paged_step
        steps = 0
        while True:
            with self._tp_ctx():
                step(s, tables, nan_at, gen)
            steps += 1
            if not bool((s.active.any()
                         & (s.active == active0).all()).item()):
                return steps

    # ------------------------------------------------------------------
    # paged mode: host loop
    # ------------------------------------------------------------------

    def _generate_paged(self, requests, gen) -> List[np.ndarray]:
        st = self.last_stats
        st.page_size = self._page
        st.num_blocks = self._num_blocks
        st.block_bytes = self._block_bytes
        self.sched.stats = st           # block / prefix counters land here
        pending = collections.deque()
        for idx, req in enumerate(requests):
            prompt, plen = self._validate_request(req)
            pending.append(dict(idx=idx, prompt=prompt, plen=plen,
                                max_new=int(req.max_new_tokens),
                                task=int(req.task)))
        results: List[Optional[np.ndarray]] = [None] * len(requests)
        s = self.init_paged_state()
        self._tables[:] = self._num_blocks
        sched = self.sched
        sched.fault_hook = (self._chaos.fail_alloc
                            if self._chaos is not None else None)
        try:
            self._paged_loop(s, pending, results, gen)
        except BaseException:
            self._reset_paged_pool()    # slot refs / pool contents are gone
            raise
        finally:
            sched.fault_hook = None
        return results  # type: ignore[return-value]

    def _paged_loop(self, s: PagedState, pending, results, gen) -> None:
        """Host half of paged serving, one replica: each iteration runs the
        chaos events, the cancel / deadline sweep (harvest -> register the
        prefix whose KV is computed -> deref blocks -> drop the adapter pin
        -> kill), FIFO admission on free blocks (and adapter slots; one
        COW copy and, on a fault, the task's column written before the
        slot is admitted), recompute preemption when the head has been
        blocked ``preempt_after`` iterations, one loop call until some
        slot's flag changes, the harvest of finished slots, and the chaos
        audit. The loop's bookkeeping is published on ``self._live``."""
        st = self.last_stats
        chaos = self._chaos
        reg = self.registry
        nblk = self._num_blocks
        meta: List[Optional[dict]] = [None] * self.max_batch
        nan_at = torch.full((self.max_batch,), -1, dtype=torch.long,
                            device=self.device)
        ttft, tpot = [], []
        # idx -> tokens harvested before a preemption; the re-admission
        # carries them in its grown prompt and ``finish`` prepends them
        prior: dict = {}
        blocked = 0             # consecutive iterations the head was blocked
        seq = 0                 # admission order: the victim is the youngest
        self._live = dict(meta=meta)

        def finish(idx, toks, status=None):
            arr = np.asarray(toks, np.int32).reshape(-1)
            pr = prior.pop(idx, None)
            if pr:
                arr = np.concatenate([np.asarray(pr, np.int32), arr])
            results[idx] = arr
            if status is not None:
                self._status[idx] = status

        def release(m, tokens, register=True):
            self.sched.release(tokens, m["blocks"], namespace=m["ns"],
                               register=register,
                               task=m["task"] if reg is not None else None)

        def kill_slot(slot):
            """Mark the slot dead and sentinel its table row, so stale
            prefill writes of the row drop."""
            s.active[slot] = False
            s.remaining[slot] = 0
            s.failed[slot] = False
            self._tables[slot] = nblk
            nan_at[slot] = -1
            meta[slot] = None

        def computed(slot):
            """(generated tokens, prompt + generated tokens, how many of
            those have their KV in the pools)."""
            m = meta[slot]
            w, done = int(s.widx[slot]), int(s.done[slot])
            toks = s.out[slot, :w].cpu().numpy().astype(np.int32)
            full = np.concatenate([m["prompt"].astype(np.int32), toks])
            return toks, full, min(done, len(full))

        def abort_slot(slot, status):
            """Harvest the slot's output, index the KV already computed,
            deref every block, drop the pin, then kill the slot."""
            m = meta[slot]
            toks, full, known = computed(slot)
            release(m, full[:known])
            kill_slot(slot)
            finish(m["idx"], toks)
            self._end(m["idx"], status)

        def preempt_one() -> bool:
            """Recompute preemption: stop the youngest running request,
            index its computed KV (so the recompute is a warm prefix hit),
            free its blocks and pin, and re-queue it right behind the
            blocked head with prompt + generated tokens and the rest of
            its token budget."""
            busy = [sl for sl in range(self.max_batch)
                    if meta[sl] is not None]
            if not busy:
                return False
            victim = max(busy, key=lambda sl: meta[sl]["seq"])
            m = meta[victim]
            toks, full, known = computed(victim)
            release(m, full[:known])
            kill_slot(victim)
            prior.setdefault(m["idx"], []).extend(int(t) for t in toks)
            self._req_preempts[m["idx"]] = (
                self._req_preempts.get(m["idx"], 0) + 1)
            st.preemptions += 1
            pending.insert(1, dict(idx=m["idx"], prompt=full,
                                   plen=len(full),
                                   max_new=m["max_new"] - len(toks),
                                   task=m["task"]))
            return True

        def sweep() -> bool:
            nonlocal pending
            swept = False
            keep = collections.deque()
            for ent in pending:
                stt = self._abort_status(ent["idx"])
                if stt is None:
                    keep.append(ent)
                    continue
                finish(ent["idx"], [])
                self._end(ent["idx"], stt)
                swept = True
            pending = keep
            for slot, m in enumerate(meta):
                if m is None:
                    continue
                stt = self._abort_status(m["idx"])
                if stt is not None:
                    abort_slot(slot, stt)
                    swept = True
            return swept

        hstep = 0
        while pending or any(m is not None for m in meta):
            faults0 = (chaos.alloc_faults + chaos.scatter_faults
                       if chaos is not None else 0)
            self._chaos_tick(hstep)
            hstep += 1
            progressed = sweep()
            # ---- admission: strict FIFO; a blocked head waits for
            # evictions rather than being overtaken (and, with
            # preempt_after set, eventually preempts)
            t_adm = time.perf_counter()
            head_blocked = admitted_any = False
            for slot in range(self.max_batch):
                if meta[slot] is not None or not pending:
                    continue
                ent = pending[0]
                ns = ent["task"] if self._kv_tasked else None
                plan = self.sched.plan(
                    ent["prompt"].tolist(), ent["max_new"], namespace=ns,
                    task=ent["task"] if reg is not None else None)
                if plan is None:        # out of KV blocks or adapter slots
                    head_blocked = True
                    break
                if (plan.adapter_fault and chaos is not None
                        and chaos.fail_scatter()):
                    # injected fault-in failure before any device work:
                    # unwind the admission — deref the planned blocks,
                    # roll the pin back (the slot stays mapped-but-
                    # UNLOADED; the retry faults again), uncount it
                    for bid in plan.blocks:
                        self.bm.deref(bid)
                    reg.release(ent["task"])
                    st.admitted -= 1
                    st.backpressure_waits += 1
                    head_blocked = True
                    break
                pending.popleft()
                progressed = admitted_any = True
                # the slot's task vector carries the POOL SLOT under the
                # registry (a cold task's column is written first)
                task_ref = ent["task"]
                if reg is not None:
                    if plan.adapter_fault:
                        self._adapter_fault_in(plan.adapter_slot,
                                               ent["task"])
                    task_ref = plan.adapter_slot
                if plan.cow is not None:
                    transformer.copy_cache_block(s.caches, *plan.cow)
                    if self._spec_on:   # the same tables address both
                        transformer.copy_cache_block(s.dcaches, *plan.cow)
                self._tables[slot] = nblk
                self._tables[slot, :len(plan.blocks)] = plan.blocks
                self._paged_admit(s, slot, ent["prompt"], plan.n_cached,
                                  ent["max_new"], task_ref)
                nan_at[slot] = self._nan_threshold(ent["idx"])
                seq += 1
                meta[slot] = dict(ent, blocks=plan.blocks, ns=ns, seq=seq,
                                  t_admit=time.perf_counter(), t_first=None)
            st.prefill_s += time.perf_counter() - t_adm
            st.kv_blocks_peak = max(st.kv_blocks_peak, self.bm.used_blocks)
            # ---- recompute preemption: the head has been blocked
            # preempt_after consecutive iterations — free the youngest
            # running request, so long requests cannot livelock the pool
            blocked = blocked + 1 if head_blocked and not admitted_any else 0
            n = self.sv.preempt_after
            if n and blocked >= n and pending and preempt_one():
                blocked = 0
                progressed = True
            # ---- step until some slot's active flag changes
            stepped = bool(s.active.any())
            if stepped:
                t_dec = time.perf_counter()
                st.decode_steps += self._paged_decode(s, nan_at, gen)
                st.decode_calls += 1
                st.decode_s += time.perf_counter() - t_dec
            # ---- harvest finished slots
            active = s.active.cpu().numpy()
            widx = s.widx.cpu().numpy()
            failed = s.failed.cpu().numpy()
            out = s.out.cpu().numpy()
            t = time.perf_counter()
            for slot, m in enumerate(meta):
                if m is None:
                    continue
                if m["t_first"] is None and widx[slot] > 0:
                    m["t_first"] = t
                    ttft.append(t - m["t_admit"])
                if active[slot]:
                    continue
                progressed = True
                ntok, bad = int(widx[slot]), bool(failed[slot])
                # prompt pages are fully computed now: index them for
                # prefix reuse (unless the NaN guard fired — suspect KV
                # is never indexed), return the rest to the free list
                release(m, m["prompt"], register=not bad)
                # the phase split is resolvable only when the first token
                # was seen at an earlier loop exit than the completion
                if m["t_first"] is not None and ntok > 1 \
                        and m["t_first"] < t:
                    tpot.append((t - m["t_first"]) / (ntok - 1))
                if bad:
                    st.failed_requests += 1
                    st.numerics_faults += 1
                finish(m["idx"], out[slot, :ntok], FAILED if bad else None)
                self._tables[slot] = nblk
                nan_at[slot] = -1
                meta[slot] = None
            if not (progressed or stepped):
                if chaos is not None and (chaos.alloc_faults
                                          + chaos.scatter_faults) > faults0:
                    # the stall was injected (forced allocation / fault-in
                    # failures blocked every admission): retry
                    chaos.stalls += 1
                    continue
                # nothing decoded, admitted or harvested: the head can
                # never fit (a request needing more KV blocks than the
                # pool can ever free)
                raise RuntimeError(
                    "paged admission deadlock: a request needs more KV "
                    "blocks (or adapter slots) than the pool can ever free")
            self._audit()
        if ttft:
            st.ttft_s = sum(ttft) / len(ttft)
        if tpot:
            st.tpot_s = sum(tpot) / len(tpot)


def _check_tp(cfg: ModelConfig, sv: ServeConfig) -> None:
    """A tensor-parallel engine needs an initialised process group of
    ``sv.tp_size`` ranks (the counterpart of the JAX engine's device
    count check), and heads, kv-heads and the padded vocab (and d_ff under
    row_parallel) that split evenly over it."""
    tp = sv.tp_size
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"ServeConfig.mesh_shape={sv.mesh_shape!r} serves one process "
            f"a rank over a torch.distributed group of {tp} ranks, and no "
            "process group is initialised "
            "(torch.distributed.init_process_group)")
    if dist.get_world_size() != tp:
        raise ValueError(
            f"ServeConfig.mesh_shape={sv.mesh_shape!r} shards {tp} ways "
            f"over the {sv.tp_axis} axis but the process group has "
            f"{dist.get_world_size()} ranks")
    for dim, name in ((cfg.num_heads, "num_heads"),
                      (cfg.num_kv_heads, "num_kv_heads"),
                      (cfg.padded_vocab, "padded_vocab")):
        if dim % tp:
            raise ValueError(
                f"{name}={dim} is not divisible by the {sv.tp_axis}-axis "
                f"size {tp}; the sharded engine slices contiguous head / "
                "vocab groups per rank")
    if sv.row_parallel and cfg.d_ff % tp:
        raise ValueError(
            f"row_parallel serving row-slices the ffn-down weight: "
            f"d_ff={cfg.d_ff} must be divisible by the {sv.tp_axis}-axis "
            f"size {tp}")


# ---------------------------------------------------------------------------
# single-shot helpers (one request shape at a time; the Engine above serves
# real traffic, tests and the chip check keep these as reference decoders)
# ---------------------------------------------------------------------------


def _pad_caches(caches, cfg: ModelConfig, batch: int, cache_len: int, *,
                device=None) -> list:
    """Place a prefill's length-T caches into fixed ``cache_len``-wide zero
    caches (``transformer.init_caches`` in the compute dtype): each leaf
    fills the leading corner of its template, the rest stays zero. A
    position whose prefill returned no cache (``{}``, the xLSTM parallel
    forms) keeps its zero state."""
    template = transformer.init_caches(cfg, batch, cache_len,
                                       cfg.compute_dtype, device=device)
    for c, z in zip(caches, template):
        for key, leaves in c.items():
            for name, src in leaves.items():
                dst = z[key][name]
                dst[tuple(slice(0, n) for n in src.shape)] = src.to(dst.dtype)
    return template


def make_serve_step(cfg: ModelConfig, spec, *, kernels=None, device=None):
    """Single-token decode step. fn(base, adapter, frozen, token (B, 1),
    caches, pos[, enc_out][, task]) -> (logits (B, V), caches), the caches
    updated in place. ``pos`` is a scalar or a (B,) per-row vector (after
    a prefill of Tp prefix rows and P tokens, decode starts at Tp + P);
    ``task`` a scalar or a (B,) task-id vector (4+1d routing);
    ``kernels`` a KernelConfig (None: the kernels for CUDA tensors);
    ``device`` where the call runs (None: the CUDA device)."""
    policy = dispatch.resolve(kernels)

    def step_fn(base, adapter, frozen, token, caches, pos, enc_out=None,
                task=None):
        bc, pl = peft_api.adapter_factors(spec, adapter, frozen)
        return transformer.decode_step(base, cfg, spec, bc, pl, token,
                                       caches, pos, enc_out=enc_out,
                                       task=task, policy=policy,
                                       device=device)

    return step_fn


def make_prefill(cfg: ModelConfig, spec, cache_len: int, *, kernels=None,
                 device=None):
    """Prefill: fn(base, adapter, frozen, tokens (B, P)[, enc_embeds][,
    embeds][, task]) -> (logits, caches padded to ``cache_len``, enc_out).
    The forward's length-T caches (T = Tp + P with a VLM prefix
    ``embeds`` (B, Tp, d)) are placed into the fixed-size decode caches
    (``_pad_caches``); an encoder-decoder returns its encoder output for
    the decode steps, else ``enc_out`` is None."""
    policy = dispatch.resolve(kernels)

    def prefill_fn(base, adapter, frozen, tokens, enc_embeds=None,
                   embeds=None, task=None):
        bc, pl = peft_api.adapter_factors(spec, adapter, frozen)
        out = transformer.forward(base, cfg, spec, bc, pl, tokens,
                                  embeds=embeds, enc_embeds=enc_embeds,
                                  task=task, policy=policy,
                                  return_caches=True, device=device)
        caches = _pad_caches(out.caches, cfg, out.logits.shape[0], cache_len,
                             device=out.logits.device)
        return out.logits, caches, out.enc_out

    return prefill_fn
