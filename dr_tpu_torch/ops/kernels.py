"""Build, load and count the port's hand-written CUDA kernels.

Each ``dr_tpu_torch/csrc/<name>.cu`` exposes a plain C interface.  At
first use every source is compiled by ``nvcc`` (one process per source,
all started together) into ``dr_tpu_torch/_build/<name>-<hash>.so``,
keyed by the source's content, and loaded with ``ctypes``; pointers and
the stream are passed as ``c_void_p``.

Routing rule (replaces the arm registry of ``dr_tpu/ops/kernels.py``):
a CUDA tensor takes the kernel or raises; a CPU tensor takes the plain
PyTorch version that sits beside each kernel.  There is no fallback: a
missing ``nvcc``, a failed build or a failed launch raises.

``launches[name]`` counts the launches of each kernel; a wrapper adds
one where it launches, and nowhere else.
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

__all__ = ["SOURCES", "launches", "reset_counts", "library", "build_all",
           "launch", "on_cuda", "stream_of", "ptr"]

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
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: argtypes of every C entry point; each returns its cudaGetLastError()
_SIGNATURES = {
    "dr_stencil_matmul": [_P, _P, _P, _L, _L, _L, _I, _I, _P],
    "dr_stencil_blocked": [_P, _P, ctypes.POINTER(ctypes.c_float), _I,
                           _L, _L, _L, _I, _P],
    "dr_chunked_dot": [_P, _P, _L, _I, _P, _P, _I, _P, _P],
    "dr_chunked_cumsum": [_P, _L, _I, _P, _P, _P, _L, _P, _P],
}

launches = {name: 0 for name in SOURCES}

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
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "dr_tpu_torch cannot be built")
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
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
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
    False when every one lies on the CPU (the plain route); a mix or any
    other device raises."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {types}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def launch(name: str, symbol: str, device, *args) -> None:
    """Call one C entry point of kernel ``name`` on ``device`` (its last
    argument is the stream), raise if the launch was refused, and count
    it."""
    fn = getattr(library(name), symbol)
    with torch.cuda.device(device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
    launches[name] += 1
