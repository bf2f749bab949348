"""The C++ bridge of the port: ``thp::session`` over ``dr_tpu_torch``.

``thp_bridge.hpp`` is the ``thp::`` surface of ``native/bridge/``, its
multi-process session (``thp::distributed``, over ``init_distributed``)
included, ``thp_bridge.cpp`` embeds CPython and calls ``dr_tpu_torch``,
``thp_expr.cpp`` serializes the op DSL.
:func:`build` compiles them with one ``main`` source into a program (the
counterpart of ``native/Makefile:6-20``), and :func:`env` is the
environment to run it with::

    from dr_tpu_torch import native
    exe = native.build(native.HERE / "bridge_demo.cpp")
    subprocess.run([str(exe), "4"], env=native.env(), check=True)

``bridge_demo 4`` drives 4 CPU ranks; ``bridge_demo 0`` the visible
CUDA devices (``session(0)`` raises without one).  ``bridge_mp_demo PID
NPROC PORT [cpu|cuda]`` is one process of NPROC, each owning one rank
(a CPU rank, or the card by default) over gloo; start all NPROC with one
PORT.  ``bridge_parity ... --mp PID NPROC PORT`` runs its sequence the
same way.  The compiler and
linker flags come from ``sysconfig`` of the running interpreter (no
``python3-config``), so the program embeds the same libpython.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

__all__ = ["HERE", "BUILD", "build", "env", "python_flags"]

HERE = Path(__file__).resolve().parent
BUILD = HERE.parent / "_build" / "native"
_REPO = HERE.parent.parent
_BRIDGE = ("thp_bridge.cpp", "thp_expr.cpp", "thp_bridge.hpp")
_CXXFLAGS = ["-std=c++20", "-O2", "-Wall"]


def python_flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) that embed this interpreter's
    libpython.  A static libpython is linked whole with
    ``--export-dynamic``, so the C extensions ``import torch`` loads
    find the interpreter's symbols in the program."""
    var = sysconfig.get_config_var
    cflags = ["-I" + sysconfig.get_paths()["include"]]
    libdir = var("LIBDIR") or ""
    extra = (var("LIBS") or "").split() + (var("SYSLIBS") or "").split()
    if var("Py_ENABLE_SHARED"):
        lflags = [f"-L{libdir}", f"-lpython{var('LDVERSION')}",
                  f"-Wl,-rpath,{libdir}"]
    else:
        names = [var("LIBRARY") or f"libpython{var('LDVERSION')}.a"]
        dirs = [libdir, var("LIBPL") or ""]
        static = next((Path(d) / n for d in dirs for n in names
                       if d and (Path(d) / n).is_file()), None)
        if static is None:
            raise RuntimeError(f"no static libpython {names} under {dirs}")
        lflags = [str(static), "-Wl,--export-dynamic"]
    return cflags, lflags + extra


def build(program_cpp, *, bridge_dir=HERE, out_dir=BUILD) -> Path:
    """Compile ``program_cpp`` with the bridge in ``bridge_dir`` (its
    ``thp_bridge.cpp``, ``thp_expr.cpp`` and ``thp_bridge.hpp``) into
    ``out_dir/<program>-<hash>``, named by a hash of the sources and
    flags, and return the path; a program already built is reused.  A
    failed build raises with the compiler's output."""
    program_cpp, bridge_dir = Path(program_cpp), Path(bridge_dir)
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the bridge")
    cflags, lflags = python_flags()
    srcs = [program_cpp] + [bridge_dir / n for n in _BRIDGE]
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.read_bytes())
    digest.update(" ".join([cxx] + _CXXFLAGS + cflags + lflags).encode())
    out_dir = Path(out_dir)
    exe = out_dir / f"{program_cpp.stem}-{digest.hexdigest()[:12]}"
    if exe.exists():
        return exe
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
    cmd = ([cxx] + _CXXFLAGS + [f"-I{bridge_dir}"] + cflags
           + [str(p) for p in srcs if p.suffix == ".cpp"]
           + ["-o", str(tmp)] + lflags)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"bridge build failed (exit {res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, exe)
    return exe


def env(base=None) -> dict:
    """The environment to run a bridge program with: ``base`` (default
    ``os.environ``) with the repository root and this interpreter's
    ``sys.path`` first on ``PYTHONPATH``, since an embedded interpreter
    does not see a virtual environment's site-packages."""
    out = dict(os.environ if base is None else base)
    paths = [str(_REPO)] + [p for p in sys.path if p]
    if out.get("PYTHONPATH"):
        paths.append(out["PYTHONPATH"])
    out["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    return out
