"""Build and load the CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with nvcc, one process per source and all
started together, into its own shared library with a plain C interface
(``build/repro_torch/<name>-<digest>.so`` under the repository root), which
``ctypes`` loads. The digest covers the sources and the flags, so an edit
rebuilds and an unchanged tree reuses what it built. A failed build raises
``RuntimeError`` carrying nvcc's stderr. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("kv_copy", "paged_attention", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_funcs: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> List[Path]:
    """Compile every named kernel whose library is missing, all at once;
    return the libraries' paths. The compiler's resource report
    (``-Xptxas -v``) is kept beside each library as ``<lib>.log``."""
    paths = [_lib_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, path in todo:
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, path, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n"
                          f"{out}{err}")
            tmp.unlink(missing_ok=True)
            continue
        path.with_suffix(".so.log").write_text(out + err)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output for a built kernel: registers, shared memory, spills."""
    return _lib_path(name).with_suffix(".so.log").read_text()


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of kernel library ``name``, built (with every
    other missing kernel) at first use. It returns a ``cudaError_t``."""
    key = f"{name}:{symbol}"
    with _lock:
        fn = _funcs.get(key)
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                build()
                lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _funcs[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (refused launches never run,
    and a later synchronize would not report them)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
