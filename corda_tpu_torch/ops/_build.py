"""Build the CUDA kernels of csrc/ and load them with ctypes.

Each ``csrc/*.cu`` compiles with nvcc, on its own and all at once, into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) under ``build/corda_tpu_torch/<sha256 of the sources>/``.
A build happens at first use; a finished library is reused by every later
process on the same checkout. A missing nvcc or a failed compile raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from . import BUILD_ROOT

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("ed25519_verify.cu", "sha512_challenge.cu", "sha256.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def source_digest() -> str:
    """sha256 over every csrc file's name and bytes (the build key)."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build_dir() -> str:
    return os.path.join(BUILD_ROOT, source_digest())


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin/ on PATH)")
    return nvcc


def _lib_path(src: str) -> str:
    return os.path.join(build_dir(), os.path.splitext(src)[0] + ".so")


def build_all() -> dict[str, str]:
    """Compile every missing library in parallel (one nvcc per source).
    Returns {source: library path}; the ptxas report of each build is kept
    beside its library as ``<name>.ptxas.txt``."""
    import time

    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    todo = [s for s in SOURCES if not os.path.exists(_lib_path(s))]
    procs = []
    if todo:
        nvcc = find_nvcc()
        for src in todo:
            tmp = f"{_lib_path(src)}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs.append((src, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        BUILD_SECONDS[src] = time.perf_counter() - t0
        text = log.decode(errors="replace")
        with open(os.path.splitext(_lib_path(src))[0] + ".ptxas.txt", "w") as f:
            f.write(text)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, _lib_path(src))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {s: _lib_path(s) for s in SOURCES}


def load(src: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<src>``; builds all on first use."""
    with _LOCK:
        lib = _LIBS.get(src)
        if lib is None:
            # lint: allow(no-jit-in-hotpath) keyed library cache: nvcc runs once per source digest (a built library is reused from disk) and each library is memoised in _LIBS; later calls are a dict lookup
            paths = build_all()
            for name, path in paths.items():
                if name not in _LIBS:
                    _LIBS[name] = ctypes.CDLL(path)
            lib = _LIBS[src]
        return lib


def ptxas_report(src: str) -> str:
    """The ``-Xptxas -v`` output of the build of ``src`` ('' if unbuilt)."""
    path = os.path.splitext(_lib_path(src))[0] + ".ptxas.txt"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
