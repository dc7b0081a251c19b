"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher (no PyTorch headers),
so ``nvcc`` takes seconds, not minutes.  Libraries go to
``<repo>/build/repro_torch/`` (listed in ``.gitignore``), named by a hash
of the nvcc flags, the source and every ``csrc`` header it includes, so
an edited kernel, header or flag is rebuilt.  Pointers and the stream
cross as ``c_void_p``; every launcher returns ``cudaGetLastError()`` (or
a code of its own for a failure before the launch) and ``check`` raises
when it is not 0.

Nothing here runs at import: the CPU tests import every module, so
``nvcc`` and the card stay out of import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

__all__ = ["KERNELS", "build_all", "capture_tally", "check",
           "check_no_grad", "count_replay", "counted_in_capture", "library",
           "nvcc_path", "operand", "stream"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: launcher symbol and argtypes of each kernel source
KERNELS = {
    "impact_scan": ("impact_scan_launch",
                    [_P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _P]),
    "topk": ("block_topk_launch",
             [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "flash_attention": ("flash_attention_launch",
                        [_P, _P, _P, _P, _P, _L, _I, _I,
                         _I, _I, _I, _I, _I, ctypes.c_float,
                         ctypes.POINTER(_I), _P]),
    "embedding_bag": ("embedding_bag_launch",
                      [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P]),
}

_lock = threading.Lock()
#: each loaded launcher, read without the lock once it is set
_launchers: dict[str, object] = {}
#: ``.d``: the calling thread's launch tally while it builds a captured
#: program (``capture_tally``), absent otherwise
_tally = threading.local()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                       "first use on a machine with the CUDA toolkit")


#: nvcc's flags for every kernel library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` files it includes (``#include
    "..."``), transitively, in the order first reached."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc_cmd(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _build_missing(names) -> dict[str, str]:
    """Compile the libraries of ``names`` that are not built yet (caller
    holds ``_lock``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    # wait for every compiler before reporting any failure, so no nvcc
    # outlives this call
    logs = {name: proc.communicate()[0]
            for name, (proc, _, _) in procs.items()}
    for name, (proc, tmp, out) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{logs[name]}")
        os.replace(tmp, out)
    return logs


def build_all() -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together.  Returns each built kernel's ``-Xptxas -v`` report
    (registers, shared memory, spills); raises if any build fails."""
    with _lock:
        return _build_missing(KERNELS)


def library(name: str):
    """The C launcher of kernel ``name``, built and loaded on first use."""
    fn = _launchers.get(name)
    if fn is not None:
        return fn
    symbol, argtypes = KERNELS[name]
    with _lock:
        if name not in _launchers:
            _build_missing([name])
            fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _launchers[name] = fn
    return _launchers[name]


def operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor: ``t`` itself when it is
    one already, which costs two attribute reads instead of two
    dispatcher calls on every launch."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, read without
    building a ``torch.cuda.Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, name: str) -> None:
    """Raise on a launch the runtime refused (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need kernel ``name``'s backward, which
    it does not have: grad mode is on and an input requires grad.  A
    launch writes into a ``torch.empty`` output with no ``grad_fn``, so
    without this check a training step would lose every gradient through
    the kernel and raise nothing.  The check runs before the device is
    looked at, so the CPU path (the plain version) refuses the same
    calls.  A differentiable route wraps the launch in a
    ``torch.autograd.Function`` (``flash_attention.ops``), whose forward
    runs with grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward and an input requires "
            "grad: call it under torch.no_grad(), on detached inputs, or "
            "through a differentiable route")


# ------------------------------------------------ launches under capture --
# A wrapper counts a launch in its module's ``n_launches``.  While a
# thread builds a captured program (``serving/programs.py``), its
# launches enqueue nothing on the device: they go into the build's tally
# instead, and every replay of the program adds the tally to the
# counters.  A counter then counts the kernels a served stage ran,
# eagerly or replayed, and none that a build ran.

def counted_in_capture(module: str, route: str | None = None) -> bool:
    """Put one launch of the kernel of ``module`` (its wrapper module's
    ``__name__``; ``route`` for a kernel that counts by route) into the
    calling thread's build tally and return True; return False when the
    thread builds no program, and the wrapper counts the launch itself."""
    tally = getattr(_tally, "d", None)
    if tally is None:
        return False
    tally[(module, route)] = tally.get((module, route), 0) + 1
    return True


@contextlib.contextmanager
def capture_tally():
    """Within the block, the calling thread's launches go into the
    yielded dict ``{(module, route): launches}``, not the counters."""
    prev = getattr(_tally, "d", None)
    _tally.d = tally = {}
    try:
        yield tally
    finally:
        _tally.d = prev


def count_replay(tally: dict) -> None:
    """Add a captured program's tally to the wrappers' counters: one
    replay runs every launch its capture recorded."""
    for (module, route), n in tally.items():
        mod = sys.modules[module]
        mod.n_launches += n
        if route is not None:
            mod.route_launches[route] = mod.route_launches.get(route, 0) + n
