"""Build and load the port's native code.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``); each ``csrc/<name>.cpp`` is host C++
compiled by ``g++``, linked against the libraries :data:`LINK_FLAGS`
names for it.  Either becomes ``build/kernels/<name>-<hash>.so`` at the
repository root, keyed by a hash of the source and its compile and link
flags, and is loaded with ``ctypes``.  No PyTorch headers are involved, so
a build takes seconds.  Nothing here runs at import: libraries build at
their first use (or when :func:`build` is called ahead of time), never
next to the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
#: Libraries a source links against, after it on the command line.
LINK_FLAGS = {"ingest": ("-ljpeg",)}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build kernels")


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: a host C++ compiler is needed to build host code")
    return found


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source of ``name`` and its compiler flags: ``.cu`` for nvcc,
    ``.cpp`` for the host compiler."""
    cu = _CSRC / f"{name}.cu"
    if cu.exists():
        return cu, NVCC_FLAGS
    return _CSRC / f"{name}.cpp", GXX_FLAGS


def library_path(name: str) -> Path:
    src, flags = _source(name)
    flags = (*flags, *LINK_FLAGS.get(name, ()))
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile every named library that is not built yet, one compiler
    process per source, all started together.  Returns name -> shared
    library path."""
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        src, flags = _source(name)
        compiler = _nvcc() if src.suffix == ".cu" else _gxx()
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(src), *LINK_FLAGS.get(name, ())]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"build failed for {name} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load library ``name``; ``signatures`` maps each
    C function to ``(restype, [argtypes])``.  Safe to call from several
    threads: the first caller builds, the others wait for it."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build(name)[name]))
                for fn, (restype, argtypes) in signatures.items():
                    getattr(lib, fn).restype = restype
                    getattr(lib, fn).argtypes = argtypes
                _loaded[name] = lib
    return lib
