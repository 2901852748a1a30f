"""Continuous-batching serving engine, dense-cache mode (counterpart of
``src/repro/serving/engine.py`` with ``ServeConfig(cache_mode="dense")``).

  * ``max_batch`` decode SLOTS, each with a ``cache_len``-cell dense KV
    cache row; per-slot state lives in one set of device tensors,
    request metadata on the host.
  * ADMISSION: a request's prompt is right-padded to a power-of-two (or
    ``prompt_buckets``) bucket and prefilled (kernel K1 for the adapted
    q/v projections, K3 for attention); its caches are copied into a free
    slot and its first token is sampled from the last prompt position.
  * DECODE: every slot steps together (K2 for q/v — each slot's A factor
    gathered by its task id — and K4 for attention) until some slot's
    active flag changes; the host then EVICTS finished slots and ADMITS
    pending requests while the others keep their state. The JAX engine
    runs this loop as one jitted ``while_loop``; eager PyTorch reads the
    active flags back once per step (a CUDA graph of the step comes
    later).
  * TASK ROUTING: with a 4+1d adapter the (B,) slot task vector gathers
    per-row C[l, t_b, m] slices from the one shared tensor train, so one
    decode batch mixes tasks.
  * NaN GUARD: a step whose logits row is non-finite stops that slot,
    keeps the tokens emitted before and ends the request FAILED.
  * LIFECYCLE: ``cancel(request_id)`` and ``Request.deadline_s`` end a
    request CANCELLED / TIMEOUT between steps, with what it emitted.

Paged mode, speculation, the adapter registry, quantization and meshes
are not ported yet: ``Engine`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.config.base import KernelConfig, ModelConfig, ServeConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import transformer
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving.adapter_runtime import PORTED, AdapterRuntime
from repro_torch.serving.stats import EngineStats


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
    task: torch.Tensor       # (B,)   per-slot task id
    failed: torch.Tensor     # (B,)   NaN guard tripped
    caches: list             # dense KV caches, batch axis = slots


class Engine:
    """Dense-cache continuous-batching engine over an ``AdapterRuntime``.

    ``serve`` must select ``cache_mode="dense"`` (the default ServeConfig
    is paged, which is not ported yet and raises). ``kernels`` picks the
    dispatch policy (default: the CUDA kernels); ``device`` is where the
    engine runs (default: the CUDA device — raising without one;
    ``device="cpu"`` runs the plain versions). The runtime's weights must
    already be on that device.
    """

    def __init__(self, model_cfg: ModelConfig, runtime: AdapterRuntime, *,
                 sampling: sampling_lib.SamplingConfig =
                 sampling_lib.SamplingConfig(),
                 seed: int = 0,
                 kernels: Optional[KernelConfig] = None,
                 serve: Optional[ServeConfig] = None,
                 device=None):
        transformer.check_supported(model_cfg)
        if runtime.mode not in PORTED:
            raise NotImplementedError(
                f"runtime mode {runtime.mode!r} is not ported yet")
        self.sv = (serve if serve is not None else ServeConfig()).validate()
        self.cfg = model_cfg
        self.rt = runtime
        self.device = resolve_device(device)
        emb = runtime.base["embed"]["tok"]
        if emb.device.type != self.device.type:
            raise RuntimeError(f"runtime weights are on {emb.device}, the "
                               f"engine runs on {self.device}")
        self.policy = dispatch.resolve(kernels)
        if self.policy.require_cuda and self.device.type != "cuda":
            raise RuntimeError("KernelConfig(backend='cuda') needs a CUDA "
                               "device")
        self.max_batch = self.sv.max_batch
        if (self.device.type == "cuda" and self.policy.backend == "kernel"
                and runtime.tasked and self.max_batch > 64):
            raise ValueError(
                f"max_batch={self.max_batch}: the batched-A kernel serves "
                "at most 64 task-routed slots per launch")
        self.cache_len = self.sv.cache_len
        self.out_cap = self.sv.out_cap
        self.prompt_buckets = tuple(sorted(self.sv.prompt_buckets))
        self.sampling = sampling.validate()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._weights = (runtime.base, runtime.broadcast, runtime.per_layer)
        self._cancel_ids: set = set()
        self.last_stats = EngineStats()
        self.last_results: List[RequestResult] = []

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

    def _prefill(self, prompt: np.ndarray, task):
        """prompt (P,) -> (last-position logits (V,), caches of the
        bucket-padded prompt, leaves (nb, 1, Pb, KV, hd))."""
        plen = prompt.shape[0]
        padded = torch.zeros((1, self._bucket(plen)), dtype=torch.long,
                             device=self.device)
        padded[0, :plen] = torch.as_tensor(prompt, device=self.device)
        base, bc, pl = self._weights
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
        return self._prefill(prompt, task if self.rt.tasked else None)[0]

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
                device=self.device))

    def _admit(self, s: DecodeState, slot: int, req: Request,
               gen: torch.Generator) -> None:
        """Prefill ``req`` into ``slot`` and sample its first token (it
        counts toward the output)."""
        prompt, plen = self._validate_request(req)
        task = int(req.task) if self.rt.tasked else None
        last, caches1 = self._prefill(prompt, task)
        t0 = sampling_lib.sample(last[None], gen, self.sampling)[0]
        transformer.insert_cache_slot(s.caches, caches1, slot)
        n_new = int(req.max_new_tokens)
        s.tok[slot, 0] = t0
        s.pos[slot] = plen
        s.remaining[slot] = n_new - 1
        s.active[slot] = n_new > 1
        s.widx[slot] = 1
        s.out[slot] = 0
        s.out[slot, 0] = t0
        s.task[slot] = int(req.task)
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

    def _decode(self, s: DecodeState, nan_at: torch.Tensor,
                gen: torch.Generator) -> int:
        """Step every slot until some slot's active flag changes (the JAX
        engine's while_loop); one host read of the flags per step."""
        active0 = s.active.clone()
        steps = 0
        while True:
            self._step(s, nan_at, gen)
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
                 nan_at: Optional[Sequence[int]] = None
                 ) -> List[np.ndarray]:
        """Serve ``requests`` through the slots; returns per request the
        generated token ids (length max_new_tokens unless the request was
        cancelled, timed out or failed). Fills ``last_stats`` and
        ``last_results``. Sampling draws from ``generator`` (default: the
        engine's own, seeded at construction). ``nan_at`` is fault
        injection for resilience tests: per request, the output column
        from which its logits are replaced by NaN (-1: never)."""
        for req in requests:
            self._validate_request(req)     # fail fast, before any work
        gen = generator if generator is not None else self.generator
        st = self.last_stats = EngineStats(requests=len(requests))
        self._rids = [req.request_id if req.request_id is not None
                      else idx for idx, req in enumerate(requests)]
        t0 = time.perf_counter()
        self._abs_deadline = [None if req.deadline_s is None
                              else t0 + req.deadline_s for req in requests]
        self._status = {}
        try:
            results = self._generate_dense(
                requests, gen, list(nan_at) if nan_at is not None
                else [-1] * len(requests))
        finally:
            self._cancel_ids.clear()
        st.wall_s = time.perf_counter() - t0
        st.tokens_generated = sum(len(r) for r in results)
        self.last_results = [
            RequestResult(tokens=r, status=self._status.get(i, FINISHED),
                          n_generated=len(r))
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

    def _generate_dense(self, requests, gen, nan_req) -> List[np.ndarray]:
        st = self.last_stats
        itemsize = torch.empty((), dtype=self.cfg.compute_dtype).element_size()
        st.page_size = self.cache_len
        st.num_blocks = self.max_batch
        st.block_bytes = (2 * self.cfg.num_layers * self.cache_len
                          * self.cfg.kv_dim * itemsize)
        st.kv_blocks_peak = self.max_batch  # dense reserves every slot
        s = self.init_state()
        pending = collections.deque(enumerate(requests))
        results: List[Optional[np.ndarray]] = [None] * len(requests)
        meta: List[Optional[int]] = [None] * self.max_batch
        nan_at = torch.full((self.max_batch,), -1, dtype=torch.long,
                            device=self.device)

        def harvest(slot: int) -> np.ndarray:
            w = int(s.widx[slot])
            return s.out[slot, :w].cpu().numpy().astype(np.int32)

        while pending or any(m is not None for m in meta):
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
            for slot, idx in enumerate(meta):
                if idx is None:
                    continue
                stt = self._abort_status(idx)
                if stt is None:
                    continue
                results[idx] = harvest(slot)
                self._end(idx, stt)
                s.active[slot] = False
                s.remaining[slot] = 0
                nan_at[slot] = -1
                meta[slot] = None
                st.evicted += 1
            # admit pending requests into free slots
            t_adm = time.perf_counter()
            admitted = 0
            for slot in range(self.max_batch):
                if meta[slot] is None and pending:
                    idx, req = pending.popleft()
                    self._admit(s, slot, req, gen)
                    meta[slot] = idx
                    nan_at[slot] = int(nan_req[idx])
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
            for slot, idx in enumerate(meta):
                if idx is not None and not active[slot]:
                    results[idx] = harvest(slot)
                    if failed[slot]:
                        self._status[idx] = FAILED
                        st.failed_requests += 1
                        st.numerics_faults += 1
                    meta[slot] = None
                    nan_at[slot] = -1
                    st.evicted += 1
        return results  # type: ignore[return-value]
