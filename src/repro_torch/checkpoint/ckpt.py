"""Checkpointing: atomic, keep-k, async-capable, resumable (counterpart
of ``src/repro/checkpoint/ckpt.py``).

A training snapshot — adapter tensors, optimizer moments, step counters —
is one ``.npz`` of the tree flattened by path plus a JSON sidecar with a
per-leaf shape manifest and the caller's meta (data-iterator state, DMRG
schedule position). Writes go to a tmp file and ``os.replace``, so a crash
mid-save never leaves a partial checkpoint; ``latest_step`` + ``restore``
implement auto-resume. The frozen base is not checkpointed (it is
deterministic from the config seed, or the pre-trained weights).

Trees are nested dicts, lists / tuples and dataclasses (the port's
``TrainState`` and ``AdamWState``), keyed by "/"-joined dict keys, list
indices and field names, as the JAX package's ``_flatten`` keys its
pytrees. bf16 is stored as f32 (npz has no bf16; the upcast is lossless)
and cast back to the template leaf's dtype on restore; int8 stays int8;
Python ints (step counters) round-trip as ints. Restored tensors land on
the template leaf's device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Optional

import numpy as np
import torch


def _children(tree):
    """(key, child) pairs of a container node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _to_savable(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "", out: Optional[dict] = None) -> dict:
    """{"/"-joined path: numpy array} over every leaf (None is skipped)."""
    out = {} if out is None else out
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            out[prefix] = _to_savable(tree)
        return out
    for k, v in kids:
        _flatten(v, f"{prefix}/{k}" if prefix else k, out)
    return out


def _restore_leaf(template, arr: np.ndarray):
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(np.array(arr, copy=True))
        return t.to(device=template.device, dtype=template.dtype)
    if isinstance(template, int):    # step counters
        return int(arr)
    return arr


def _unflatten_into(template, arrays: dict, prefix: str = ""):
    """``template``'s structure with every leaf replaced by its saved
    array (shape-flexible: the saved shape wins). A leaf missing from the
    checkpoint raises ``KeyError`` naming it."""
    kids = _children(template)
    if kids is None:
        if template is None:
            return None
        if prefix not in arrays:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        return _restore_leaf(template, arrays[prefix])
    new = {k: _unflatten_into(v, arrays, f"{prefix}/{k}" if prefix else k)
           for k, v in kids}
    if isinstance(template, dict):
        return {k: new[str(k)] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(new[str(i)] for i in range(len(template)))
    return dataclasses.replace(template, **new)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_base_snapshot(path: str, base: Any) -> str:
    """Atomic one-file snapshot of a serving base tree (an int8 engine's
    packed ``{"q8", "scale"}`` leaves stay int8, so a restart loads them
    instead of re-quantizing). Returns the path written."""
    path = _npz_path(path)
    arrays = _flatten(base)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_base_snapshot(path: str, template: Any) -> Any:
    """Inverse of ``save_base_snapshot``: ``template`` supplies the tree
    structure, dtypes and device. Snapshots written by the JAX package's
    ``save_base_snapshot`` load too: the two packages' base trees have the
    same keys (``convert.py``)."""
    with np.load(_npz_path(path)) as z:
        arrays = dict(z)
    return _unflatten_into(template, arrays)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}")

    def all_steps(self) -> list:
        return sorted(int(n[len("ckpt_"):-len(".npz")])
                      for n in os.listdir(self.dir)
                      if n.startswith("ckpt_") and n.endswith(".npz"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None) -> None:
        """Atomic save of ``tree``; ``meta`` must be JSON-serializable.
        The arrays are copied to the host before this returns, so an
        async save may run while training moves on."""
        self.wait()
        arrays = _flatten(tree)

        def _write():
            base = self._path(step)
            tmp = base + f".tmp.{os.getpid()}"
            with open(tmp + ".npz", "wb") as f:
                np.savez(f, **arrays)
            # per-leaf shape manifest: DMRG sweeps change the cores' bond
            # shapes mid-run, and restore() takes the saved shapes
            manifest = {"step": step,
                        "shapes": {k: list(v.shape)
                                   for k, v in arrays.items()},
                        **(meta or {})}
            with open(tmp + ".json", "w") as f:
                json.dump(manifest, f)
            os.replace(tmp + ".json", base + ".json")
            os.replace(tmp + ".npz", base + ".npz")
            self._gc()

        if self.async_save:
            def _run():
                try:
                    _write()
                except Exception as e:   # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        """Join the async save in flight; a write that failed raises
        here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep] if self.keep else []:
            for ext in (".npz", ".json"):
                try:
                    os.remove(self._path(s) + ext)
                except FileNotFoundError:
                    pass

    def restore(self, step: int, template: Any) -> tuple:
        """(tree, meta); ``template`` provides structure, dtypes and
        devices. Saved arrays replace template leaves of another shape
        (TT ranks change at a DMRG sweep)."""
        base = self._path(step)
        with np.load(base + ".npz") as z:
            arrays = dict(z)
        meta = {}
        if os.path.exists(base + ".json"):
            with open(base + ".json") as f:
                meta = json.load(f)
        return _unflatten_into(template, arrays), meta

    def restore_latest(self, template: Any) -> Optional[tuple]:
        step = self.latest_step()
        if step is None:
            return None
        tree, meta = self.restore(step, template)
        return step, tree, meta
