"""Build the CUDA sources under ``csrc/`` with ``nvcc`` at first use and
load them with ``ctypes``.

Each source becomes ``build/lib<name>-<hash>.so`` beside the package
(``build/`` is git-ignored); the hash covers the source and the
flags, so an edited source is never served from a stale library.
Nothing is compiled when a module is imported.  ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills per kernel)
is kept in ``build/<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
        "CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every named source that has no current library, one
    ``nvcc`` per source, all started together."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT,
        )))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        details = "\n".join(
            (BUILD_DIR / f"{n}.log").read_text()[-4000:] for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{details}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
