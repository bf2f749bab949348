"""Build, load and count the port's hand-written CUDA kernels.

Each ``dr_tpu_torch/csrc/<name>.cu`` exposes a plain C interface.  At
first use every source is compiled by ``nvcc`` (one process per source,
all started together) into ``dr_tpu_torch/_build/<name>-<hash>.so``,
keyed by the source's content, and loaded with ``ctypes``; pointers and
the stream are passed as ``c_void_p``.

Routing rule (replaces the arm registry of ``dr_tpu/ops/kernels.py``):
a CUDA tensor takes the kernel or raises; a CPU tensor takes the plain
PyTorch version that sits beside each kernel.  There is no fallback: a
missing ``nvcc``, a failed build or a failed launch raises classified
(``utils/resilience``, site ``kernel.build``).  The ``kernel.build``
fault site fires at every build and at every launch, before the kernel
runs and before its counter moves: an armed fault raises out of the
wrapper, and the plain version does not run in its place.  A CPU tensor
never reaches it.

``launches[name]`` counts the launches of each kernel; a wrapper adds
one where it launches, and nowhere else.  A kernel that serves as
another's entry point counts under its own name: ``hist`` (K8, a
histogram's bincount) launches the ``segred`` library and is counted as
``hist`` alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..utils import faults as _faults
from ..utils.resilience import ProgramError, classified

__all__ = ["SOURCES", "COUNTERS", "launches", "reset_counts", "library",
           "build_all", "launch", "on_cuda", "stream_of", "ptr"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

#: kernel name -> its CUDA source under csrc/
SOURCES = {
    "stencil_matmul": "stencil_matmul.cu",
    "stencil_blocked": "stencil_blocked.cu",
    "chunked_dot": "dot.cu",
    "chunked_cumsum": "scan.cu",
    "stencil2d_blocked": "stencil2d_blocked.cu",
    "bitonic_sort": "bitonic_sort.cu",
    "segred": "segred.cu",
    "flash_update": "flash_attention.cu",
    "stencil_step": "stencil_step.cu",
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: argtypes of every C entry point; each returns its cudaGetLastError()
_SIGNATURES = {
    "dr_stencil_matmul": [_P, _P, _P, _L, _L, _L, _I, _I, _I, _P],
    "dr_stencil_blocked": [_P, _P, ctypes.POINTER(ctypes.c_float), _I,
                           _L, _L, _L, _I, _P],
    "dr_chunked_dot": [_P, _P, _L, _I, _P, _P, _I, _P, _P],
    "dr_chunked_cumsum": [_P, _L, _I, _P, _P, _L, _P, _P],
    "dr_stencil2d_blocked": [_P, _P, ctypes.POINTER(ctypes.c_float), _I,
                             _L, _L, _I, _I, _P],
    "dr_bitonic_sort": [_P, _P, _L, _I, _L, _P, _P, _P],
    "dr_segred": [_P, _L, _I, _I, ctypes.POINTER(_L), ctypes.POINTER(_I),
                  ctypes.POINTER(_I), ctypes.POINTER(_L), _P, _P],
    "dr_segred_workspace_ints": [],
    "dr_flash_update": [_P] * 9 + [_I] * 5 + [_L, _L, _I, _P],
    "dr_stencil_step": [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_float), _I,
                        _L, _L, _L, _L, _P],
}

#: the launch counters: one per source, and K8 on segred's library
COUNTERS = tuple(SOURCES) + ("hist",)
launches = {name: 0 for name in COUNTERS}

_libs: dict = {}
#: seconds the last build_all() spent compiling
last_build_seconds = 0.0


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise ProgramError("nvcc not found: the CUDA kernels of "
                           "dr_tpu_torch cannot be built",
                           site="kernel.build")
    return nvcc


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + ARCH.encode()).hexdigest()
    return BUILD / f"{src.stem}-{digest[:12]}.so"


def build_all(names=None) -> dict:
    """Compile (in parallel) and load the kernels not loaded yet;
    returns ``{name: ctypes.CDLL}``."""
    global last_build_seconds
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if n not in _libs]
    if not todo:
        return {n: _libs[n] for n in names}
    for name in todo:
        _faults.fire("kernel.build", kernel=name)
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        src = CSRC / SOURCES[name]
        so = _target(src)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
               "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, so)
    errors = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, so)
        (BUILD / f"{so.stem}.ptxas.txt").write_text(out)
    if errors:
        raise ProgramError("CUDA kernel build failed:\n" + "\n".join(errors),
                           site="kernel.build")
    last_build_seconds = time.perf_counter() - t0
    for name in todo:
        lib = ctypes.CDLL(str(_target(CSRC / SOURCES[name])))
        for sym, argtypes in _SIGNATURES.items():
            if hasattr(lib, sym):
                getattr(lib, sym).argtypes = argtypes
                getattr(lib, sym).restype = ctypes.c_int
        _libs[name] = lib
    return {n: _libs[n] for n in names}


def library(name: str):
    """The loaded shared library of one kernel (built on first use)."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all([name])[name]


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on a CUDA device (the kernel route),
    False when every one lies on the CPU (the plain route) or every one
    is a ``meta`` tensor (the plan verifier's shape-only replay, which
    the plain version serves without data); a mix or any other device
    raises."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"} or types == {"meta"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {types}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


#: the cudaError codes whose text the classifier reads (cudaGetErrorString)
_CUDA_ERRORS = {2: "out of memory", 700: "an illegal memory access was "
                "encountered", 719: "unspecified launch failure"}


def launch(name: str, symbol: str, device, *args, counter=None) -> None:
    """Call one C entry point of kernel ``name`` on ``device`` (its last
    argument is the stream), raise classified if the launch was refused,
    and count it under ``counter`` (default ``name``).  The
    ``kernel.build`` fault site fires first."""
    _faults.fire("kernel.build", kernel=counter or name)
    fn = getattr(library(name), symbol)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise classified(RuntimeError(
            f"CUDA kernel {name} failed to launch (cudaError {err}: "
            f"{_CUDA_ERRORS.get(err, 'see cudaGetErrorString')})"),
            site="kernel.build")
    launches[counter or name] += 1
