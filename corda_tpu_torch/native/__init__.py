"""The port's native cores: C extensions built at first use.

Counterpart of ``corda_tpu/native/__init__.py`` for ``_cverify.c`` (batched
libcrypto verify and signing and the device-hash word packer, GIL
released, and ``pack_jobs``, the device provider's one pass from VerifyJob
objects to words), ``_ccodec.c`` (the canonical codec's decode/encode core,
wired in by serialization/codec.py) and ``_ccommit.c`` (the CRC32C of
every durable row's integrity frame, one row or a whole commit batch,
wired in by node/services/integrity.py). Each source compiles with ``gcc``
against the interpreter's ``Python.h`` (and, for ``_cverify``, the
installed libcrypto) into ``build/corda_tpu_torch/native/<sha256 of the
source>/``, through a temp name and ``os.replace``, so processes that
build at once never load a half-written file and a changed source never
loads a stale build. A host without a toolchain or libcrypto gets None:
the numpy packer, the oracle path and the pure-Python codec answer
identically, only slower.
"""

from __future__ import annotations

import glob
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
import threading
import time

from ..ops import BUILD_ROOT

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_CACHE: dict[str, object] = {}  # module name -> module or None
BUILD_SECONDS: dict[str, float] = {}  # module name -> seconds of its gcc run


def build_path(name: str) -> str:
    """Where the extension built from ``<name>.c`` lives (built or not)."""
    with open(os.path.join(_SRC_DIR, name + ".c"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_ROOT, "native", digest, name + suffix)


def _import(name: str, path: str):
    loader = importlib.machinery.ExtensionFileLoader(f"{__name__}.{name}",
                                                     path)
    spec = importlib.util.spec_from_file_location(loader.name, path,
                                                  loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def _load_native(name: str, link_args: tuple = ()):
    """The extension built from ``<name>.c``, building it on first use.
    Returns the module, or None when it cannot be built or loaded (no
    compiler, no headers, a failed build)."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        target = build_path(name)
        module = None
        if not os.path.exists(target):
            _build(name, target, link_args)
        if os.path.exists(target):
            try:
                module = _import(name, target)
            except ImportError:
                module = None
        _CACHE[name] = module
        return module


def _build(name: str, target: str, link_args: tuple) -> None:
    include = sysconfig.get_paths()["include"]
    os.makedirs(os.path.dirname(target), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(target))
    os.close(fd)
    t0 = time.perf_counter()
    try:
        subprocess.run(
            ["gcc", "-O2", "-fPIC", "-shared", f"-I{include}",
             os.path.join(_SRC_DIR, name + ".c"), "-o", tmp, *link_args],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _libcrypto_path():
    """The installed libcrypto shared object, headers or not: an image may
    ship libcrypto.so.3 without the dev symlink, so the build links the
    versioned file directly."""
    for pattern in ("/usr/lib/*/libcrypto.so", "/lib/*/libcrypto.so",
                    "/usr/lib/*/libcrypto.so.*", "/lib/*/libcrypto.so.*",
                    "/usr/lib/libcrypto.so*", "/usr/local/lib/libcrypto.so*"):
        hits = sorted(glob.glob(pattern))
        if hits:
            return hits[0]
    return None


def load_cverify():
    """The batched libcrypto verify core and word packer (``_cverify.c``),
    or None when libcrypto or a toolchain is absent. The answer is kept
    for the process: callers ask once per batch."""
    if "_cverify" in _CACHE:
        return _CACHE["_cverify"]
    lib = _libcrypto_path()
    if lib is None:
        _CACHE["_cverify"] = None
        return None
    return _load_native("_cverify", (lib,))


def load_ccodec():
    """The native codec decode/encode core (``_ccodec.c``), or None when
    it cannot be built here."""
    return _load_native("_ccodec")


def load_ccommit():
    """The CRC32C integrity-frame core (``_ccommit.c``), or None
    when it cannot be built here (integrity.py then runs its Python
    CRC32C, bit for bit the same)."""
    return _load_native("_ccommit")


def pack_backend() -> str:
    """Which packer the device-hash path uses on this host: "native"
    (``_cverify.pack_words``) or "numpy" (the fallback)."""
    return "native" if load_cverify() is not None else "numpy"
