"""Serve-time tensor parallelism (counterpart of the serve-TP part of
``src/repro/sharding/rules.py``).

The JAX engine wraps its step graphs in ``shard_map`` over a (data,
model) mesh inside one process. The port runs one process a rank over a
``torch.distributed`` process group: every rank holds the whole model and
runs the same engine with the same seed, and inside a step the call sites
consult this context. Attention slices this rank's contiguous group of
q / k / v heads (the KV cache holds only this rank's kv-head stripe) and
all-gathers the per-head outputs; the tied-embedding readout computes
this rank's padded-vocab stripe and all-gathers the logits; under
``row_parallel`` the second matmul of each attention / FFN pair keeps its
input sharded, row-slices its weight and all-reduces the partial sums.
The collectives are ``all_gather`` and ``all_reduce``, which gloo (the
CPU) and NCCL (the card) both take.

The context is set only by the ``serve_tp`` context manager, which the
engine wraps around a step; without it (training, prefill, the
single-device engine) every helper here is the identity.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

#: the kv-head axis of every serving cache leaf: paged pools (nb, N, page,
#: KV, hd) and their int8 scale pools (nb, N, page, KV), dense caches
#: (nb, B, S, KV, hd). Pages, blocks and positions stay whole, so one
#: host-side block id indexes every rank's pool alike.
CACHE_HEAD_AXIS = 3

_serve_tp: list = [None]     # (group, size, rank) or None
_serve_rp: list = [False]


def get_serve_tp() -> bool:
    """True inside a serve-TP context."""
    return _serve_tp[0] is not None


def get_serve_rp() -> bool:
    """True when the row-parallel variant is on inside a serve-TP
    context."""
    return _serve_rp[0]


@contextlib.contextmanager
def serve_tp(group, size: int, row_parallel: bool = False):
    """The serve-TP context over process group ``group`` (None: the
    default group) of ``size`` ranks for the body of a ``with`` block
    (the counterpart of the JAX engine's ``_shard_mapped`` wrapper); the
    only place the context is set, and it is cleared on the way out."""
    _serve_tp[0] = (group, int(size), dist.get_rank(group))
    _serve_rp[0] = bool(row_parallel)
    try:
        yield
    finally:
        _serve_tp[0] = None
        _serve_rp[0] = False


def serve_tp_slice(x: torch.Tensor, axis: int) -> torch.Tensor:
    """This rank's contiguous chunk of dim ``axis`` (a view); identity
    without a context. The engine checks up front that heads, kv-heads
    and the padded vocab divide the group. Slicing a dim that is not
    contracted changes no element's reduction order."""
    tp = _serve_tp[0]
    if tp is None:
        return x
    _, size, rank = tp
    if x.shape[axis] % size:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split "
                         f"{size} ways")
    n = x.shape[axis] // size
    return x.narrow(axis, rank * n, n)


def serve_tp_gather(x: torch.Tensor, axis: int) -> torch.Tensor:
    """All-gather every rank's chunk back into the whole dim ``axis``
    (rank order), the inverse of ``serve_tp_slice``; identity without a
    context."""
    tp = _serve_tp[0]
    if tp is None:
        return x
    group, size, _ = tp
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


def serve_psum(x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) the ranks' partial outputs (the row-parallel
    epilogue); identity without a context."""
    tp = _serve_tp[0]
    if tp is None:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=tp[0])
    return x


def serve_cache_stripe(caches):
    """This rank's kv-head stripe of every leaf of a cache tree (views);
    identity without a context. The dense engine's prefill is whole on
    every rank; its admission writes only the stripe into the slot."""
    if isinstance(caches, dict):
        return {k: serve_cache_stripe(v) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return type(caches)(serve_cache_stripe(v) for v in caches)
    return serve_tp_slice(caches, CACHE_HEAD_AXIS)
