"""Loading contract code from attachments, vetted before execution.

The port's own copy of ``corda_tpu/contracts/attachments_loader.py``.
What differs: an attachment's import of the JAX package's name for a
platform module resolves to this package's module of the same path
(``sandbox.platform_module_name``), so one attachment zip, with one hash,
loads and verifies in both packages; ``corda_tpu`` is never imported.

Capability match for the reference's AttachmentsClassLoader (reference:
core/src/main/kotlin/net/corda/core/node/AttachmentsClassLoader.kt:23-103):
contract logic ships *on the ledger* as content-addressed attachment
archives, and a node verifying a transaction materialises the contract
classes from those attachments rather than from its own install. The
reference scans every attachment JAR up front, rejects overlapping file
paths (case-insensitively — OverlappingAttachments), serves classes and
resources only from the scanned set, and notes its future direction is a
sandboxing classloader ("defence in depth").

Python form: an attachment is a zip of ``.py`` sources + resources. The
loader scans all archives with the same overlap rule, and *imports are
closed over the attachment set*: a module executes with a private
``__import__`` that resolves sibling modules from the attachments and only
lets whitelisted platform modules through. Every module's code is statically
vetted by the DeterministicSandbox **before** it is executed — the
"sandboxing classloader" the reference left as a TODO — so attachment code
gets the same determinism guarantees as any sandboxed contract, at load time
rather than first call.
"""

from __future__ import annotations

import builtins as _builtins
import io
import types
import zipfile

from .sandbox import (
    ALLOWED_BUILTINS,
    DEFAULT_MODULE_WHITELIST,
    DeterministicSandbox,
    SandboxViolation,
    _EXCEPTION_NAMES,
    platform_module_name,
)
from .structures import Attachment, Contract


class OverlappingAttachments(Exception):
    """Two attachments define the same (case-folded) path
    (AttachmentsClassLoader.kt:27-29)."""

    def __init__(self, path: str):
        super().__init__(f"Multiple attachments define a file at path {path}")
        self.path = path


class AttachmentsModuleLoader:
    """Loads Python modules and resources from a set of attachments
    (AttachmentsClassLoader.kt findClass/findResource/getResourceAsStream)."""

    def __init__(self, attachments: list[Attachment],
                 sandbox: DeterministicSandbox | None = None):
        self._paths: dict[str, bytes] = {}
        self._modules: dict[str, types.ModuleType] = {}
        self._loading: set[str] = set()
        for attachment in attachments:
            archive = zipfile.ZipFile(io.BytesIO(attachment.open()))
            for info in archive.infolist():
                if info.is_dir():
                    continue
                # Reject case-only and separator-only variants, exactly as
                # the reference does for Windows/Mac developer filesystems.
                path = info.filename.lower().replace("\\", "/")
                if path in self._paths:
                    raise OverlappingAttachments(path)
                self._paths[path] = archive.read(info)
        module_names = tuple(
            p[:-3].replace("/", ".") for p in self._paths if p.endswith(".py"))
        # The *platform* whitelist is what real imports may fall through to;
        # attachment names extend only the vetting whitelist. Keeping the two
        # separate stops a hostile attachment from whitelisting a host
        # package by shipping a same-named stub (e.g. an empty os.py plus
        # `from os.path import ...`).
        self._platform_whitelist = (
            sandbox.module_whitelist if sandbox else DEFAULT_MODULE_WHITELIST)
        self._sandbox = sandbox or DeterministicSandbox(
            module_whitelist=DEFAULT_MODULE_WHITELIST + module_names)

    # ------------------------------------------------------------- modules

    def load_module(self, name: str) -> types.ModuleType:
        """Import a module from the attachment set (findClass:68-84). The
        source is sandbox-vetted before exec; unknown names raise
        ModuleNotFoundError (the reference's ClassNotFoundException)."""
        if name in self._modules:
            return self._modules[name]
        path = name.replace(".", "/").lower() + ".py"
        source = self._paths.get(path)
        if source is None:
            raise ModuleNotFoundError(f"{name} is not in the attachments")
        if name in self._loading:
            raise ImportError(f"circular attachment import: {name}")
        self._loading.add(name)
        try:
            code = compile(source, f"attachment://{path}", "exec")
            self._sandbox._vet_code(code, {})
            module = types.ModuleType(name)
            module.__dict__["__builtins__"] = self._restricted_builtins()
            self._modules[name] = module
            try:
                exec(code, module.__dict__)
            except BaseException:
                del self._modules[name]
                raise
            return module
        finally:
            self._loading.discard(name)

    def _restricted_builtins(self) -> dict:
        """Builtins for attachment modules: ONLY the sandbox-allowed names
        plus exception types and class-machinery hooks — not the real
        builtins dict. Static vetting is the first line of defence; this is
        the second, so that even a dynamically-reached ``__builtins__``
        subscript yields nothing beyond the whitelist. ``__import__`` is the
        shim that resolves sibling modules from the attachment set and only
        lets *platform*-whitelisted modules through."""
        loader = self

        def attachment_import(name, globals=None, locals=None, fromlist=(),
                              level=0):
            if level != 0:
                raise SandboxViolation(
                    "relative imports are not supported in attachments")
            if name.replace(".", "/").lower() + ".py" in loader._paths:
                if "." in name and not fromlist:
                    # `import a.b` binds the root name; keep the namespace
                    # model flat instead of emulating package machinery.
                    raise SandboxViolation(
                        f"use 'from {name} import ...' for dotted "
                        "attachment modules")
                return loader.load_module(name)
            platform_name = platform_module_name(name)
            if not any(platform_name == w or platform_name.startswith(w + ".")
                       for w in loader._platform_whitelist):
                raise SandboxViolation(
                    f"attachment import of non-whitelisted module {name!r}")
            return _builtins.__import__(platform_name, globals, locals,
                                        fromlist, level)

        b = {name: getattr(_builtins, name)
             for name in (ALLOWED_BUILTINS | _EXCEPTION_NAMES)
             if hasattr(_builtins, name)}
        b["__build_class__"] = _builtins.__build_class__
        b["__name__"] = "attachment"
        b["None"] = None
        b["True"] = True
        b["False"] = False
        b["NotImplemented"] = NotImplemented
        b["__import__"] = attachment_import
        return b

    # ----------------------------------------------------------- resources

    def get_resource(self, path: str) -> bytes:
        """Raw file bytes from the attachment set (findResource /
        getResourceAsStream). KeyError if absent."""
        return self._paths[path.lower().replace("\\", "/")]

    # ----------------------------------------------------------- contracts

    def load_contract(self, qualified_name: str) -> Contract:
        """'module.ClassName' -> a vetted Contract instance, ready for
        sandboxed verification (the AttachmentsClassLoader + ContractExecutor
        composition)."""
        module_name, _, cls_name = qualified_name.rpartition(".")
        module = self.load_module(module_name)
        cls = getattr(module, cls_name, None)
        if not (isinstance(cls, type) and issubclass(cls, Contract)):
            raise TypeError(f"{qualified_name} is not a Contract")
        contract = cls()
        self._sandbox.vet_contract(contract)
        return contract


def make_attachment_zip(files: dict[str, bytes]) -> bytes:
    """Helper (used by tests and tooling): path -> content mapping to a
    deterministic zip blob suitable for attachment storage."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for path in sorted(files):
            info = zipfile.ZipInfo(path, date_time=(1980, 1, 1, 0, 0, 0))
            z.writestr(info, files[path])
    return buf.getvalue()
