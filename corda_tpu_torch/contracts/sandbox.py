"""Deterministic contract sandbox: static vetting + runtime cost accounting.

The port's own copy of ``corda_tpu/contracts/sandbox.py``. What differs:
the trusted platform is this package (``DEFAULT_MODULE_WHITELIST`` names
``corda_tpu_torch.*``), and an import of the JAX package's name for a
platform module (``corda_tpu.contracts.structures``) vets as the port's
module of the same path (``platform_module_name``). Contract code shipped
as an attachment is ledger data with one hash, so it names the platform
as the reference does and verifies in both packages; the name is only
rewritten, ``corda_tpu`` itself is never imported, and a name that is not
whitelisted after the rewrite (``corda_tpu.ops``) is refused as any other
import is, under the name the code wrote.

Capability match for the reference's experimental deterministic-JVM sandbox
(reference: experimental/sandbox/src/main/java/net/corda/sandbox/
WhitelistClassLoader.java:21, CandidacyStatus.java, costing/
RuntimeCostAccounter.java, costing/ContractExecutor.java): contract
verification logic must be (a) *deterministic* — every node replaying the
same transaction must reach the same verdict, so clocks, randomness, IO,
process state and reflection are off limits — and (b) *bounded* — a hostile
contract must not be able to stall a notary with an infinite loop or an
allocation bomb.

The reference enforces (a) by ASM-rewriting bytecode through a whitelist
classloader and (b) by injecting cost-accounting call sites at every branch,
allocation, invoke and throw. The Python equivalents used here:

- **Static vetting** (`vet`): walk the contract's code objects with `dis`,
  resolving every global/builtin reference and import. Only whitelisted
  builtins, whitelisted modules (the ledger data model plus pure-math
  stdlib), and code defined in whitelisted modules may be reached.
  Forbidden names (``open``, ``eval``, ``exec``, ``globals``, ``id``,
  ``hash``, …) and non-whitelisted imports fail vetting with the offending
  name, mirroring WhitelistCheckingClassVisitor's reason codes.
- **Runtime cost accounting** (`run`): execute under a ``sys.settrace``
  tracer counting line transitions (the reference's *jump* cost), calls
  (*invoke* cost) and raised exceptions (*throw* cost), plus a peak-memory
  watermark via ``tracemalloc`` (*allocation* cost). Any budget breach
  raises ``SandboxCostExceeded`` inside the traced frame, aborting
  verification exactly like RuntimeCostAccounter's kill thresholds.

Known limits (documented, as the reference's README documents its own):
native builtins (e.g. ``sorted`` of a huge list) execute outside the line
tracer, so their time is bounded only indirectly by the allocation budget;
and set/dict *iteration order* over hash-randomised strings is not policed —
ledger ids are immune because the canonical codec sorts by encoding.
"""

from __future__ import annotations

import builtins
import dis
import sys
import tracemalloc
import types
from dataclasses import dataclass

from .structures import Contract
from .verification import TransactionForContract


class SandboxViolation(Exception):
    """Static vetting failed: the code can reach a non-deterministic or
    non-whitelisted facility (WhitelistClassloadingException equivalent)."""


class SandboxCostExceeded(Exception):
    """A runtime cost budget was breached (RuntimeCostAccounter kill)."""

    def __init__(self, kind: str, spent: int, budget: int):
        super().__init__(
            f"contract exceeded its {kind} budget: {spent} > {budget}")
        self.kind = kind
        self.spent = spent
        self.budget = budget


@dataclass(frozen=True)
class CostBudget:
    """Kill thresholds (RuntimeCostAccounter.java BASELINE_*_KILL_THRESHOLD,
    scaled for line-level rather than branch-level accounting)."""

    jumps: int = 1_000_000  # line transitions
    invokes: int = 200_000  # Python-level calls
    throws: int = 50
    alloc_bytes: int = 1 << 20  # 1 MiB peak above the starting watermark


# Builtins a contract may use: pure, deterministic, side-effect free.
ALLOWED_BUILTINS = frozenset({
    "abs", "all", "any", "bin", "bool", "bytearray", "bytes", "callable",
    "chr", "classmethod", "dict", "divmod", "enumerate", "filter", "float",
    "format",
    "frozenset", "hex", "int", "isinstance", "NotImplemented",
    "issubclass", "iter", "len", "list", "map", "max", "min", "next",
    "object", "oct", "ord", "pow", "property", "range", "repr", "reversed",
    "round", "set", "slice", "sorted", "staticmethod", "str", "sum", "super",
    "tuple", "type", "zip",
})

# Explicitly banned names — each with the determinism/containment reason.
FORBIDDEN_BUILTINS = frozenset({
    "open", "input", "print",            # IO
    "eval", "exec", "compile", "__import__",  # dynamic code loading
    "globals", "locals", "vars", "dir", "__builtins__",  # environment
                                         # reflection (subscripting
                                         # __builtins__ reaches everything)
    "getattr", "hasattr",                # string-named attribute access would
                                         # bypass the FORBIDDEN_ATTRS check
    "id", "hash",                        # address/seed dependent values
    "memoryview", "breakpoint", "exit", "quit", "help",
    "setattr", "delattr",                # state mutation outside the tx view
})

# Modules whose code a contract may call into. The ledger data model is
# trusted (it is the platform), plus a small pure-math stdlib allowance.
# `operator` is deliberately absent: attrgetter/methodcaller take string
# attribute names and would bypass the FORBIDDEN_ATTRS LOAD_ATTR check
# (operator.attrgetter('__globals__') reaches real builtins). `copy` and
# `re` are absent because their module-level caches (_copy_dispatch,
# re._cache) are mutable via STORE_SUBSCR, which static vetting cannot see.
DEFAULT_MODULE_WHITELIST = (
    "corda_tpu_torch.contracts",
    "corda_tpu_torch.crypto",
    "corda_tpu_torch.finance",
    "corda_tpu_torch.serialization",
    "corda_tpu_torch.transactions",
    "math", "cmath", "decimal", "fractions", "itertools", "functools",
    "dataclasses", "enum", "typing", "abc", "numbers",
    "collections",
)

# Reflection attributes that escape any static whitelist if reachable
# (SandboxRemapper.java's rewrite targets, translated to CPython).
FORBIDDEN_ATTRS = frozenset({
    "__globals__", "__builtins__", "__code__", "__closure__", "__dict__",
    "__subclasses__", "__getattribute__", "__reduce__", "__reduce_ex__",
    "__loader__", "__spec__", "__import__", "gi_frame", "f_globals",
    # str.format's replacement-field mini-language does attribute traversal
    # ("{0.__globals__}") outside any LOAD_ATTR the vetter can see; f-strings
    # compile to real LOAD_ATTR opcodes and stay usable.
    "format", "format_map", "vformat",
})

# Names that define WHERE code claims to come from. Assigning them (module
# body `__name__ = "math"`, class body `__module__ = "math"`) would let
# hostile code impersonate a whitelisted module and borrow its trust, so the
# vetter rejects the stores. One emission is excused: every class body
# implicitly runs `__module__ = __name__` (LOAD_NAME __name__ directly
# before the store) — harmless, because __name__ itself cannot be forged.
# (__doc__ / __all__ / __qualname__ stay assignable — no trust decision
# reads them.)
_IDENTITY_NAMES = frozenset({
    "__name__", "__module__", "__package__",
    "__builtins__", "__loader__", "__spec__", "__class__",
})

# Exception types are fine to reference (contracts raise to reject).
_EXCEPTION_NAMES = frozenset(
    n for n in dir(builtins)
    if isinstance(getattr(builtins, n), type)
    and issubclass(getattr(builtins, n), BaseException))


def _module_allowed(name: str, whitelist: tuple[str, ...]) -> bool:
    return any(name == w or name.startswith(w + ".") for w in whitelist)


# The JAX package's top-level name, as contract code written for either
# package spells the platform (module doc), and this package's.
REFERENCE_PLATFORM = "corda_tpu"
PLATFORM = "corda_tpu_torch"


def platform_module_name(name: str) -> str:
    """The module an import of ``name`` resolves to here: the JAX
    package's ``corda_tpu.<x>`` is this package's ``corda_tpu_torch.<x>``;
    any other name is itself."""
    if name == REFERENCE_PLATFORM or name.startswith(REFERENCE_PLATFORM + "."):
        return PLATFORM + name[len(REFERENCE_PLATFORM):]
    return name


# The interpreter-level callable types that genuinely carry no __code__ /
# __globals__. Only these may earn trust through module OWNERSHIP in
# _trusted_home — any Python-defined object can forge the same attribute
# surface, but it cannot forge its C-level type.
_C_CALLABLE_TYPES = (
    types.BuiltinFunctionType,  # == BuiltinMethodType
    types.WrapperDescriptorType,
    types.MethodWrapperType,
    types.MethodDescriptorType,
    types.ClassMethodDescriptorType,
)


def _is_dataclass_hash(cls: type, attr) -> bool:
    """True only for the __hash__ dataclasses generates for frozen/eq
    classes: defined on a dataclass, compiled from the '<string>' source
    dataclasses uses, reaching nothing but the hash() builtin and the
    class's own field names, and carrying no constants. Anything else —
    including a hand-written hash smuggling code — gets vetted normally.
    (Forging this shape needs compile()/exec(), which module vetting bans.)
    """
    code = getattr(attr, "__code__", None)
    # co_consts may carry the empty tuple: a fieldless frozen dataclass
    # hashes `()`, so its generated __hash__ embeds it as a constant.
    return (isinstance(attr, types.FunctionType)
            and code is not None
            and "__dataclass_fields__" in vars(cls)
            and code.co_filename == "<string>"
            and not code.co_freevars
            and set(code.co_consts) <= {None, ()}
            and set(code.co_names)
            <= {"hash"} | set(cls.__dataclass_fields__))


class DeterministicSandbox:
    """Vets and executes contract verification code (ContractExecutor.java:
    execute/isSuitable, with vetting transitive like WhitelistClassLoader's
    candidacy resolution)."""

    def __init__(self, budget: CostBudget = CostBudget(),
                 module_whitelist: tuple[str, ...] = DEFAULT_MODULE_WHITELIST):
        self.budget = budget
        self.module_whitelist = tuple(module_whitelist)
        self._vetted: set[types.CodeType] = set()
        self._vetting_instances: set[int] = set()

    # ------------------------------------------------------------- vetting

    def is_suitable(self, contract: Contract) -> bool:
        """Non-raising form of vet (ContractExecutor.isSuitable)."""
        try:
            self.vet_contract(contract)
            return True
        except SandboxViolation:
            return False

    def vet_contract(self, contract: Contract) -> None:
        self.vet(type(contract).verify)

    def vet(self, fn) -> None:
        """Statically verify every name `fn` can reach, transitively through
        functions defined in non-whitelisted (i.e. user) modules. Functions
        *defined in* whitelisted modules are trusted as-is (the platform is
        the trust root, exactly as the reference's classloader trusts the
        JDK/platform jars it doesn't rewrite)."""
        fn = getattr(fn, "__func__", fn)
        if self._trusted_home(fn):
            return
        code = getattr(fn, "__code__", None)
        if code is None:
            raise SandboxViolation(f"not vettable: {fn!r}")
        closure: dict = {}
        for name, cell in zip(code.co_freevars, fn.__closure__ or ()):
            try:
                closure[name] = cell.cell_contents
            except ValueError:
                pass  # unbound cell; resolves to NameError at runtime
        self._vet_code(code, getattr(fn, "__globals__", {}), closure)

    def _trusted_home(self, fn) -> bool:
        """Is `fn` genuinely defined in a whitelisted module? Both name
        sources a function carries — __module__ (which functools.wraps
        copies from the wrapped function) and __globals__['__name__'] —
        are just strings that hostile module-level code could forge before
        vetting ever runs. So a name alone is NOT trusted: the function's
        __globals__ must BE the claimed module's real namespace
        (sys.modules identity). Forging that requires replacing a
        sys.modules entry, which needs `sys` (not whitelisted) or
        setattr/STORE_ATTR (both vetted away). The __module__ leg accepts
        e.g. platform functions; the __globals__ leg accepts whitelisted-
        module wrappers whose __module__ was overwritten by wraps (e.g.
        dataclasses' _recursive_repr around a generated __repr__).

        C-level callables (math.floor, a descriptor's builtin accessor)
        carry no __globals__ at all, so the identity check above can never
        pass; for those, trust requires the claimed whitelisted module to
        actually OWN the object — it is bound to the module (__self__) or
        reachable under its own name there. A bare __module__ string still
        earns nothing."""
        globs = getattr(fn, "__globals__", None)
        if globs is None and getattr(fn, "__code__", None) is None:
            # Only REAL C-callable types qualify for the ownership leg: a
            # user instance can forge __module__/__self__ as class
            # attributes (type() with an arbitrary dict) but cannot forge
            # its own Python type.
            if not isinstance(fn, _C_CALLABLE_TYPES):
                return False
            mod_name = getattr(fn, "__module__", None)
            if not isinstance(mod_name, str) or not _module_allowed(
                    mod_name, self.module_whitelist):
                return False
            owner = sys.modules.get(mod_name)
            if owner is None:
                return False
            if getattr(fn, "__self__", None) is owner:
                return True
            return getattr(owner, getattr(fn, "__name__", ""), None) is fn
        names = (getattr(fn, "__module__", None),
                 globs.get("__name__") if globs else None)
        for name in names:
            if not isinstance(name, str) or not _module_allowed(
                    name, self.module_whitelist):
                continue
            mod = sys.modules.get(name)
            if mod is not None and getattr(mod, "__dict__", None) is globs:
                return True
        return False

    def _trusted_class(self, cls: type) -> bool:
        """Is `cls` genuinely defined in a whitelisted module (or builtins)?
        Like _trusted_home, a bare __module__ string is forgeable
        (functools.wraps works on classes too), so the claimed module must
        actually own the class: walking the qualname from the module object
        must arrive back at this exact class object."""
        mod_name = getattr(cls, "__module__", None)
        if not isinstance(mod_name, str):
            return False
        if mod_name == "builtins":
            owner = builtins
        elif _module_allowed(mod_name, self.module_whitelist):
            owner = sys.modules.get(mod_name)
        else:
            return False
        obj = owner
        for part in getattr(cls, "__qualname__", cls.__name__).split("."):
            if part == "<locals>" or obj is None:
                return False
            obj = getattr(obj, part, None)
        return obj is cls

    def _vet_code(self, code: types.CodeType, globs: dict,
                  closure: dict | None = None) -> None:
        if code in self._vetted:
            return
        # Mark before recursing so cycles terminate, but UNWIND on failure:
        # leaving a failed code object in the cache would let the same
        # malicious contract pass a later vet on this sandbox instance.
        self._vetted.add(code)
        try:
            self._vet_code_inner(code, globs, closure)
        except BaseException:
            self._vetted.discard(code)
            raise

    def _vet_code_inner(self, code: types.CodeType, globs: dict,
                        closure: dict | None = None) -> None:
        where = f"{code.co_filename}:{code.co_name}"

        prev = None
        for inst in dis.get_instructions(code):
            if inst.opname in ("IMPORT_NAME", "IMPORT_FROM"):
                mod = str(inst.argval)
                if inst.opname == "IMPORT_NAME" and not _module_allowed(
                        platform_module_name(mod), self.module_whitelist):
                    raise SandboxViolation(
                        f"{where}: import of non-whitelisted module {mod!r}")
            elif inst.opname in ("LOAD_GLOBAL", "LOAD_NAME"):
                self._vet_name(str(inst.argval), globs, where)
            elif inst.opname == "LOAD_DEREF" and closure \
                    and inst.argval in closure:
                self._vet_value(str(inst.argval), closure[inst.argval], where)
            elif inst.opname in ("LOAD_ATTR", "LOAD_METHOD"):
                if str(inst.argval) in FORBIDDEN_ATTRS:
                    raise SandboxViolation(
                        f"{where}: access to reflection attribute "
                        f"{inst.argval!r}")
            elif inst.opname in ("STORE_GLOBAL", "DELETE_GLOBAL"):
                # Persistent module-level state makes replays diverge.
                raise SandboxViolation(
                    f"{where}: mutation of global {inst.argval!r}")
            elif inst.opname in ("STORE_NAME", "DELETE_NAME") \
                    and str(inst.argval) in _IDENTITY_NAMES:
                implicit_class_module = (
                    inst.argval == "__module__" and prev is not None
                    and prev.opname == "LOAD_NAME"
                    and prev.argval == "__name__")
                if not implicit_class_module:
                    raise SandboxViolation(
                        f"{where}: assignment to identity name "
                        f"{inst.argval!r}")
            elif inst.opname in ("STORE_ATTR", "DELETE_ATTR"):
                # Contracts must treat the tx view (and anything reachable
                # from it, including platform modules) as immutable.
                raise SandboxViolation(
                    f"{where}: attribute mutation {inst.argval!r}")
            prev = inst

        # The docstring slot (co_consts[0] of a non-lambda code object) is
        # exempt from the dunder scan below: docs and error text legitimately
        # *mention* names like __dict__, and this scan is evadable
        # defense-in-depth anyway — precision beats breadth here. But
        # co_consts[0] is only a docstring if the code never
        # USES it as data: in `X = "__globals__"` (no docstring) the string
        # lands in slot 0 too, so exempt it only when it is never loaded, or
        # loaded solely to be stored as __doc__ (the module-body pattern).
        doc = None
        if (code.co_consts and isinstance(code.co_consts[0], str)
                and code.co_name != "<lambda>"):
            doc = code.co_consts[0]
            insts = list(dis.get_instructions(code))
            for i, ins in enumerate(insts):
                if ins.opname == "LOAD_CONST" and ins.argval is doc:
                    nxt = insts[i + 1] if i + 1 < len(insts) else None
                    if not (nxt is not None and nxt.opname == "STORE_NAME"
                            and nxt.argval == "__doc__"):
                        doc = None  # slot 0 is data, not a docstring
                        break
        for const in code.co_consts:
            if isinstance(const, types.CodeType):
                self._vet_code(const, globs)
            elif isinstance(const, str) and const is not doc:
                # Reflection attribute names smuggled as *data* — e.g. a
                # string handed to a platform helper that does attribute
                # lookup. Defense in depth only: a string assembled at
                # runtime ("__glo"+"bals__" via join) evades a constant
                # scan, which is why str.format itself is banned via
                # FORBIDDEN_ATTRS above. Scan for the dunder names only;
                # "format" itself appears in ordinary message text.
                for banned in FORBIDDEN_ATTRS:
                    if banned.startswith("__") and banned in const:
                        raise SandboxViolation(
                            f"{where}: string constant embeds reflection "
                            f"attribute {banned!r}")

    def _vet_name(self, name: str, globs: dict, where: str) -> None:
        if name in FORBIDDEN_BUILTINS:
            raise SandboxViolation(
                f"{where}: use of forbidden builtin {name!r}")
        if name in globs:
            self._vet_value(name, globs[name], where)
            return
        if name in ALLOWED_BUILTINS or name in _EXCEPTION_NAMES:
            return
        if name in ("__name__", "__qualname__", "__module__", "__doc__",
                    "__debug__", "__build_class__"):
            return  # interpreter-supplied metadata in class/module bodies
        if hasattr(builtins, name):
            raise SandboxViolation(
                f"{where}: builtin {name!r} is not whitelisted")
        # A truly unresolvable name would NameError at runtime; fine.

    def _vet_value(self, name: str, value, where: str) -> None:
        if isinstance(value, types.ModuleType):
            if not _module_allowed(value.__name__, self.module_whitelist):
                raise SandboxViolation(
                    f"{where}: reference to non-whitelisted module "
                    f"{value.__name__!r} (as {name!r})")
            return
        # Functions and classes FIRST: their __module__ is a bare string
        # functools.wraps can stamp with a whitelisted name, so it earns no
        # trust here. vet() / _trusted_class decide by sys.modules identity
        # and everything that fails that check is vetted as user code.
        if isinstance(value, (types.FunctionType, types.MethodType)):
            self.vet(value)
            return
        if isinstance(value, type):
            if self._trusted_class(value):
                # Ownership established — but an ALIAS of a forbidden
                # builtin type (memoryview) must still fail the name
                # screen, exactly as the spelled-out name would.
                if value.__module__ == "builtins":
                    self._vet_name(value.__name__, {}, where)
                return
            self._vet_class(value, where)
            return
        if callable(value) and getattr(value, "__code__", None) is None \
                and self._trusted_home(value):
            return  # C-level callable genuinely owned by a whitelisted module
        mod = getattr(value, "__module__", None)
        if mod == "builtins" and isinstance(value, _C_CALLABLE_TYPES):
            # Identity discipline, not a string compare: a user instance
            # forging __module__="builtins" has the wrong Python type and
            # never lands here; a genuine C callable must additionally BE
            # the object the builtins namespace owns under its qualname
            # (len, dict.get, ...) before the name screen decides.
            obj = builtins
            for part in getattr(value, "__qualname__",
                                getattr(value, "__name__", "")).split("."):
                obj = getattr(obj, part, None)
            if obj is value:
                self._vet_name(getattr(value, "__name__", name), {}, where)
                return
            raise SandboxViolation(
                f"{where}: C callable {name!r} claims builtins but is not "
                f"owned by it")
        if isinstance(value, (int, float, str, bytes, bool, complex)) \
                or value is None:
            return  # immutable scalar constants
        if isinstance(value, (tuple, frozenset)):
            # Immutable CONTAINERS are only as safe as their contents: a
            # tuple is the one-line smuggle for a real builtin ((open,)[0]
            # from confined code), so every element is vetted.
            for i, item in enumerate(value):
                self._vet_value(f"{name}[{i}]", item, where)
            return
        # Instances pass only when their CLASS genuinely lives in a
        # whitelisted module (identity, not the forgeable string) AND the
        # instance is an immutable value shape whose PAYLOAD also vets:
        # mutable containers are cross-replay state, and callable wrappers
        # (functools.partial over open) or a frozen dataclass field holding
        # open smuggle real builtins past confinement.
        self._vet_instance(name, value, where)

    def _vet_instance(self, name: str, value, where: str) -> None:
        """Vet an instance global: trusted-class enum members, frozen
        dataclasses (fields vetted recursively — a field can hold any
        object), and the well-known numeric value types. Deliberately
        closed-world: everything else is rejected."""
        import dataclasses
        import decimal
        import enum
        import fractions

        cls = type(value)
        if self._trusted_class(cls):
            if id(value) in self._vetting_instances:
                return  # cycle (only constructible by platform C tricks)
            self._vetting_instances.add(id(value))
            try:
                if isinstance(value, enum.Enum):
                    self._vet_value(f"{name}.value", value.value, where)
                    return
                params = getattr(cls, "__dataclass_params__", None)
                if params is not None and getattr(params, "frozen", False):
                    for f in dataclasses.fields(cls):
                        self._vet_value(f"{name}.{f.name}",
                                        getattr(value, f.name, None), where)
                    return
                if isinstance(value, (decimal.Decimal, fractions.Fraction)):
                    return
            finally:
                self._vetting_instances.discard(id(value))
        raise SandboxViolation(
            f"{where}: global {name!r} of type {type(value).__name__} from "
            f"non-whitelisted module "
            f"{getattr(value, '__module__', None)!r}")

    def _vet_class(self, cls: type, where: str,
                   seen: set[type] | None = None) -> None:
        """Vet every executable attribute of a user class: plain functions,
        class/static methods, property fget/fset/fdel, functools.wraps
        chains, nested classes, and user base classes. (A function-only
        walk would let code smuggled in a property run unconfined.)"""
        seen = set() if seen is None else seen
        if cls in seen:
            return
        seen.add(cls)
        for base in cls.__bases__:
            if self._trusted_class(base):
                continue
            self._vet_class(base, where, seen)
        for name, attr in vars(cls).items():
            if name in ("__dict__", "__weakref__", "__doc__", "__module__",
                        "__qualname__", "__firstlineno__",
                        "__static_attributes__", "__slots__",
                        "__annotations__", "__match_args__",
                        "__dataclass_fields__", "__dataclass_params__",
                        "__parameters__", "__orig_bases__",
                        "__abstractmethods__", "_abc_impl"):
                continue
            # __hash__ is vetted like any method (a blanket skip would let a
            # user-defined __hash__ run unvetted — a full escape
            # the moment an instance lands in a set). The ONE shape excused
            # is the dataclass-generated hash, which calls the otherwise-
            # forbidden hash() builtin; it is recognised by provenance and
            # body shape, not by name.
            if name == "__hash__" and _is_dataclass_hash(cls, attr):
                continue
            attr = getattr(attr, "__func__", attr)  # class/staticmethod
            if isinstance(attr, property):
                for accessor in (attr.fget, attr.fset, attr.fdel):
                    if accessor is not None:
                        self.vet(accessor)
                continue
            wrapped = getattr(attr, "__wrapped__", None)
            if isinstance(wrapped, (types.FunctionType, types.MethodType)):
                self.vet(wrapped)
            if isinstance(attr, (types.FunctionType, types.MethodType)):
                self.vet(attr)
                continue
            if isinstance(attr, type):
                self._vet_class(attr, where, seen)
                continue
            if attr is None or isinstance(
                    attr, (int, float, str, bytes, bool, complex)):
                continue
            if isinstance(attr, (tuple, frozenset)):
                # Same contents rule as module globals: `T = (open,)` as a
                # class attribute is the identical smuggle one level down.
                self._vet_value(f"{cls.__name__}.{name}", attr, where)
                continue
            # Arbitrary descriptors (functools.cached_property, user
            # __get__ objects, …) carry code the simple walk above misses:
            # vet every embedded callable we can find, and FAIL CLOSED on
            # attributes we cannot see into — an unrecognised mutable or
            # executable class attribute is exactly where smuggled code or
            # cross-replay state hides.
            vetted_embedded = False
            for accessor_name in ("func", "fget", "fset", "fdel",
                                  "__wrapped__", "__call__"):
                f = getattr(attr, accessor_name, None)
                f = getattr(f, "__func__", f)
                if isinstance(f, (types.FunctionType, types.MethodType)):
                    self.vet(f)
                    vetted_embedded = True
            if not vetted_embedded:
                raise SandboxViolation(
                    f"{where}: unvettable class attribute {name!r} of type "
                    f"{type(attr).__name__}")

    # ----------------------------------------------------------- execution

    def _confine(self, fn):
        """Rebuild a *user* entry function over a globals dict whose
        ``__builtins__`` holds only the allowed names — runtime defense in
        depth behind static vetting, the same belt-and-braces the
        attachments loader uses. Platform (whitelisted-module) functions run
        unmodified."""
        fn = getattr(fn, "__func__", fn)
        # Same identity rule as vetting: a wraps-stamped __module__ string
        # must not exempt user code from confinement.
        if self._trusted_home(fn):
            return fn
        code = getattr(fn, "__code__", None)
        if code is None:
            return fn
        restricted = {n: getattr(builtins, n)
                      for n in (ALLOWED_BUILTINS | _EXCEPTION_NAMES)
                      if hasattr(builtins, n)}
        restricted["__build_class__"] = builtins.__build_class__
        globs = dict(fn.__globals__)
        globs["__builtins__"] = restricted
        confined = types.FunctionType(
            code, globs, fn.__name__, fn.__defaults__, fn.__closure__)
        confined.__kwdefaults__ = fn.__kwdefaults__
        return confined

    def run(self, fn, *args, **kwargs):
        """Vet, then execute under the cost tracer. Returns fn's result;
        raises SandboxViolation / SandboxCostExceeded."""
        self.vet(fn)
        fn = self._confine(fn)
        budget = self.budget
        counts = {"jump": 0, "invoke": 0, "throw": 0}

        def charge(kind: str, limit: int) -> None:
            counts[kind] += 1
            if counts[kind] > limit:
                raise SandboxCostExceeded(kind, counts[kind], limit)

        def check_alloc() -> None:
            current, peak = tracemalloc.get_traced_memory()
            if max(current, peak) - base > budget.alloc_bytes:
                raise SandboxCostExceeded(
                    "alloc", max(current, peak) - base, budget.alloc_bytes)

        def tracer(frame, event, arg):
            if event == "call":
                charge("invoke", budget.invokes)
                return tracer
            if event == "line":
                charge("jump", budget.jumps)
                # Kill allocation bombs *mid-loop*, not after the damage is
                # done; sampled so the common case stays cheap.
                if counts["jump"] % 64 == 0:
                    check_alloc()
            elif event == "exception":
                charge("throw", budget.throws)
            return tracer

        started_tracemalloc = not tracemalloc.is_tracing()
        if started_tracemalloc:
            tracemalloc.start()
        else:
            tracemalloc.reset_peak()
        base, _ = tracemalloc.get_traced_memory()
        old_trace = sys.gettrace()
        sys.settrace(tracer)
        try:
            result = fn(*args, **kwargs)
        finally:
            sys.settrace(old_trace)
            _, peak = tracemalloc.get_traced_memory()
            if started_tracemalloc:
                tracemalloc.stop()
        allocated = max(0, peak - base)
        if allocated > budget.alloc_bytes:
            raise SandboxCostExceeded("alloc", allocated, budget.alloc_bytes)
        return result

    def execute(self, contract: Contract, tx: TransactionForContract) -> None:
        """Run a contract's verify inside the sandbox
        (ContractExecutor.execute)."""
        self.run(type(contract).verify, contract, tx)


def sandboxed_verify(tx: TransactionForContract,
                     sandbox: DeterministicSandbox | None = None) -> None:
    """Verify every contract referenced by a transaction inside one sandbox —
    the drop-in hardened twin of platform contract verification."""
    sandbox = sandbox or DeterministicSandbox()
    contracts = {s.contract for s in tx.inputs} | {
        s.contract for s in tx.outputs}
    for contract in sorted(contracts, key=lambda c: type(c).__name__):
        sandbox.execute(contract, tx)
