"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into ``build/lib<name>.so``
at the repository root (``REPRO_TORCH_BUILD_DIR`` overrides the
directory) and is loaded with ``ctypes``: a plain C interface, device
pointers and the CUDA stream passed as ``c_void_p``. The sources share
the Hopper helpers of ``csrc/*.cuh`` (``-I csrc``); a library is rebuilt
when its source or any header is newer. ``build_all`` starts one ``nvcc``
per source at once; ``library`` builds on first use.

Nothing here runs at import time, so the CPU tests import every kernel
module without a CUDA toolkit. There is no fallback: a missing ``nvcc``,
a failed build or a card below compute capability 9.0 raises.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("tt_linear", "flash_attention", "flash_attention_bwd",
           "paged_attention")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict = {}
_counters: dict = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
        "kernels are built from src/repro_torch/kernels/csrc on first use")


def _lib_path(name: str) -> pathlib.Path:
    return build_dir() / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def _start(name: str) -> tuple:
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
    log = open(out / f"{name}.build.log", "w")
    cmd = [_nvcc(), *ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-lineinfo", "-I", str(CSRC), "-o",
           str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, log


def _finish(name: str, proc, tmp, log) -> None:
    rc = proc.wait()
    log.close()
    if rc != 0:
        text = (build_dir() / f"{name}.build.log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={rc}):\n{text}")
    os.replace(tmp, _lib_path(name))


def build_all(force: bool = False) -> dict:
    """Compile every stale source in parallel; returns {name: log path}."""
    with _lock:
        todo = [n for n in SOURCES if force or _stale(n)]
        started = [(n, *_start(n)) for n in todo]
        err = None
        for n, proc, tmp, log in started:
            try:
                _finish(n, proc, tmp, log)
            except RuntimeError as e:   # wait for every nvcc, then raise
                err = err or e
        if err is not None:
            raise err
    return {n: build_dir() / f"{n}.build.log" for n in SOURCES}


def check_device(t: torch.Tensor) -> None:
    """The kernels are compiled for sm_90a only."""
    cap = torch.cuda.get_device_capability(t.device)
    if cap < (9, 0):
        raise RuntimeError(
            f"the CUDA kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(t.device)} has compute "
            f"capability {cap}. Use KernelConfig(backend='ref') for the "
            "plain PyTorch versions")


def check_no_grad(ts, what: str) -> None:
    """Raise if autograd is recording and an input requires grad: a
    kernel's output has no ``grad_fn``, so it would silently cut the
    graph. ``dispatch.py``'s ``autograd.Function``s call the wrappers with
    recording off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{what}: an input requires grad and the raw kernel wrapper "
            "has no backward; differentiate through kernels/dispatch.py")


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu`` (built if stale)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if _stale(name):
                _finish(name, *_start(name))
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters on ``device``, for a
    kernel whose blocks merge a split in a fixed order (#8 / #8q's chunks
    of a window): the last block of a group resets its counter to zero, so
    the buffer is allocated and zeroed once and reused by every launch.
    Launches that share it are ordered on one stream, as the engine's
    are."""
    t = _counters.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[device] = t
    return t


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
