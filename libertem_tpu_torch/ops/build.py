"""Build the sources under ``csrc/`` at first use and load them with
``ctypes``: the CUDA sources (``<name>.cu``) with ``nvcc``, the host
decoders (``<name>.cpp``) with ``g++ -O3 -shared -fPIC``.

Each source becomes ``build/lib<name>-<hash>.so`` beside the package
(``build/`` is git-ignored); the hash covers the source and the
flags, so an edited source is never served from a stale library.
Nothing is compiled when a module is imported.  Every compiler writes
to a name of its own process and the result is moved into place with
``os.replace``, so processes that build the same library at once (the
test workers) never load a half-written one.  The compiler's output
(for ``nvcc`` the ``-Xptxas -v`` report: registers, shared memory,
spills per kernel) is kept in ``build/<name>.log``; a failed build
raises with it.
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
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError(
        "g++ not found on PATH: the host decoders cannot be built")


def _source(name: str) -> Path:
    for suffix in (".cu", ".cpp"):
        path = CSRC_DIR / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no source {name}.cu or {name}.cpp in "
                            f"{CSRC_DIR}")


def _command(src: Path) -> list:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS]
    return [_gxx(), *GXX_FLAGS]


def library_path(name: str) -> Path:
    src = _source(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every named source that has no current library, one
    compiler per source, all started together."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        src = _source(name)
        out = library_path(name)
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        log_path = out.with_name(f"{name}.{os.getpid()}.log")
        log = open(log_path, "w")
        cmd = [*_command(src), "-o", str(tmp), str(src)]
        procs.append((name, out, tmp, log_path, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT,
        )))
    failed = []
    for name, out, tmp, log_path, log, proc in procs:
        rc = proc.wait()
        log.close()
        os.replace(log_path, BUILD_DIR / f"{name}.log")
        if rc != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        details = "\n".join(
            (BUILD_DIR / f"{n}.log").read_text()[-4000:] for n in failed
        )
        raise RuntimeError(f"the build failed for {failed}:\n{details}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
