"""Carry weights from the JAX package into the port.

``from_jax_numpy(params)`` takes the JAX package's ``{"base", "adapter",
"frozen"}`` pytree after ``jax.device_get`` — plain dicts and lists of
numpy arrays — and returns the same structure as torch tensors, so both
packages compute the same function. The layout is unchanged (base leaves
stacked ``(nb, ...)`` per pattern position); nothing is re-initialized.
bf16 arrays (ml_dtypes) cross through a uint16 view, because numpy has no
bf16 that torch accepts. A base packed by the JAX package's
``quantize_base`` crosses as it is: its ``{"q8": int8, "scale": f32}``
leaves keep their dtypes, so the port's ``kernels.quant`` output can be
compared with it leaf for leaf. This module imports neither JAX nor anything of
the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def array_to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    return array_to_tensor(tree, device)


def from_jax_numpy(params, *, device=None):
    """numpy pytree -> tensor pytree on ``device`` (None: the CUDA
    device, raising without one)."""
    return _convert(params, resolve_device(device))
