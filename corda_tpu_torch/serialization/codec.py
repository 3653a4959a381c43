"""Canonical, deterministic, whitelisted binary serialization.

The port's own copy of ``corda_tpu/serialization/codec.py``: the same wire
format and the same wire names (the package prefix is stripped from both),
so the two packages exchange blobs byte for byte. The JAX package's native
decode core (``corda_tpu/native/_ccodec.c``) is not carried over; this
pure-Python codec is its semantic authority there too.

Capability match for the reference's Kryo layer (reference:
core/src/main/kotlin/net/corda/core/serialization/Kryo.kt:41-507): one format
serves the wire protocol, transaction-component hashing and flow checkpoints,
with a registration whitelist so deserialization can never instantiate
unexpected classes (the reference gets this from registered Kryo serializers
and its attack-surface notes).

Unlike Kryo this format is *canonical* in both directions: a value has exactly
one encoding (sorted dict/set entries, minimal varints), and the decoder
*rejects* any non-canonical byte string (non-minimal varints, unsorted or
duplicate entries) — so distinct blobs never decode to equal values and every
stored blob is tamper-evident by re-hash. This matters because transaction ids
are Merkle roots over serialized components (reference:
core/.../transactions/WireTransaction.kt:45-52, MerkleTransaction.kt:26-38)
and must be stable across processes, hosts and framework versions. Design:

  tag byte, then payload:
    0x00 None        0x01 False        0x02 True
    0x03 int         zigzag varint (arbitrary precision)
    0x04 bytes       varint length + raw
    0x05 str         varint length + utf-8
    0x06 list/tuple  varint count + items
    0x07 dict        varint count + alternating key/value, entries sorted by
                     encoded key (canonical regardless of insertion order)
    0x08 object      registered type name (str payload) + varint field count
                     + field values in dataclass field order
    0x09 frozenset   varint count + items sorted by their encodings
    0x0A float       8-byte IEEE-754 big-endian; finite only, -0.0
                     normalized to 0.0 (one encoding per equal value)

Dataclasses register with `@register` (or `register_class`); the registry maps
a stable wire name to the class. Deserializing an unregistered name raises
DeserializationError — the whitelist seam that mirrors the reference's
controlled Kryo registration.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Type, TypeVar

T = TypeVar("T")

_TAG_NONE = 0x00
_TAG_FALSE = 0x01
_TAG_TRUE = 0x02
_TAG_INT = 0x03
_TAG_BYTES = 0x04
_TAG_STR = 0x05
_TAG_LIST = 0x06
_TAG_DICT = 0x07
_TAG_OBJECT = 0x08
_TAG_FROZENSET = 0x09
_TAG_FLOAT = 0x0A


class DeserializationError(Exception):
    pass


_BY_NAME: dict[str, type] = {}
_BY_TYPE: dict[type, str] = {}
_CUSTOM_ENC: dict[type, Callable[[Any], tuple]] = {}
_CUSTOM_DEC: dict[str, Callable[[tuple], Any]] = {}
# type -> (encoded wire-name bytes, tuple of field names) — computed once per
# class; dataclasses.fields() + str.encode() per encode call was the hottest
# line in the notary-roundtrip profile.
_ENC_PLAN: dict[type, tuple[bytes, tuple[str, ...]]] = {}
# wire name -> (cls, ((field name, is_list_typed), ...)) for decode.
_DEC_PLAN: dict[str, tuple[type, tuple[tuple[str, bool], ...]]] = {}
# Immutable value types whose full encoding may be memoized on the instance
# (attribute _codec_enc). Opt-in via mark_cacheable: the type must be deeply
# immutable plain data (no service tokens), so the bytes stay valid for the
# object's lifetime. SignedTransaction in a flow's checkpoint args was being
# re-encoded on every suspension.
_CACHEABLE: set[type] = set()


def mark_cacheable(*classes: type) -> None:
    """Enable instance-level encoding memoization for immutable value types."""
    _CACHEABLE.update(classes)


def register_class(
    cls: Type[T],
    name: str | None = None,
    encode: Callable[[Any], tuple] | None = None,
    decode: Callable[[tuple], Any] | None = None,
) -> Type[T]:
    """Whitelist a class for serialization.

    Dataclasses need no encode/decode: their fields (in declaration order) are
    the wire representation. Other classes supply encode (instance -> tuple of
    serializable values) and decode (tuple -> instance).
    """
    # The package prefix is stripped, so a port class's wire name equals its
    # JAX-package counterpart's ("crypto.hashes.SecureHash") and every
    # encoding, and so every transaction id, is byte-identical across them.
    wire_name = name or (f"{cls.__module__.removeprefix('corda_tpu_torch.')}."
                         f"{cls.__qualname__}")
    if wire_name in _BY_NAME and _BY_NAME[wire_name] is not cls:
        raise ValueError(f"wire name {wire_name!r} already registered")
    _BY_NAME[wire_name] = cls
    _BY_TYPE[cls] = wire_name
    if encode is not None:
        _CUSTOM_ENC[cls] = encode
    if decode is not None:
        _CUSTOM_DEC[wire_name] = decode
    elif not dataclasses.is_dataclass(cls):
        raise ValueError(f"{cls} is not a dataclass; provide encode/decode")
    return cls


def register(cls: Type[T]) -> Type[T]:
    """Decorator form of register_class for dataclasses."""
    return register_class(cls)


def wire_name_of(cls: type) -> str | None:
    """The registered wire name of a class, None when unregistered.

    Public read-side of the registry for stores that index rows by state
    type (the vault's state_type pushdown column): the wire name is the
    one type identifier that is stable across processes and refactors,
    unlike __qualname__ paths."""
    return _BY_TYPE.get(cls)


def class_for_wire_name(name: str) -> type | None:
    """The class registered under a wire name, None when unknown."""
    return _BY_NAME.get(name)


# Resolved lazily on the first object encode (.tokens imports this module,
# so a top-level import would be circular); a per-call `from .tokens import`
# in the encode hot path showed up in profiles at firehose load.
SerializeAsToken = None
current_token_context = None


def _write_varint(out: bytearray, n: int) -> None:
    if n < 0:
        raise ValueError("varint must be non-negative")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if pos >= len(data):
            raise DeserializationError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            # Canonicality: a multi-byte varint whose final group is zero has
            # a shorter encoding — reject so every int has exactly one form.
            if b == 0 and shift > 0:
                raise DeserializationError("non-minimal varint")
            return result, pos
        shift += 7


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> (n.bit_length() + 1)) if n < 0 else n << 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _encode(out: bytearray, value: Any) -> None:
    if value is None:
        out.append(_TAG_NONE)
    elif value is False:
        out.append(_TAG_FALSE)
    elif value is True:
        out.append(_TAG_TRUE)
    elif isinstance(value, int):
        out.append(_TAG_INT)
        _write_varint(out, _zigzag(value))
    elif isinstance(value, float):
        import math
        import struct as _struct

        if not math.isfinite(value):
            raise TypeError("non-finite floats are not serializable")
        if value == 0.0:
            value = 0.0  # normalize -0.0: equal values, one encoding
        out.append(_TAG_FLOAT)
        out.extend(_struct.pack(">d", value))
    elif isinstance(value, bytes):
        out.append(_TAG_BYTES)
        _write_varint(out, len(value))
        out.extend(value)
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out.append(_TAG_STR)
        _write_varint(out, len(raw))
        out.extend(raw)
    elif isinstance(value, (list, tuple)):
        out.append(_TAG_LIST)
        _write_varint(out, len(value))
        for item in value:
            _encode(out, item)
    elif isinstance(value, dict):
        entries = []
        for k, v in value.items():
            kbuf = bytearray()
            _encode(kbuf, k)
            vbuf = bytearray()
            _encode(vbuf, v)
            entries.append((bytes(kbuf), bytes(vbuf)))
        entries.sort()  # canonical: equal dicts encode identically
        out.append(_TAG_DICT)
        _write_varint(out, len(entries))
        for kenc, venc in entries:
            out.extend(kenc)
            out.extend(venc)
    elif isinstance(value, frozenset):
        encs = []
        for item in value:
            buf = bytearray()
            _encode(buf, item)
            encs.append(bytes(buf))
        encs.sort()
        out.append(_TAG_FROZENSET)
        _write_varint(out, len(encs))
        for e in encs:
            out.extend(e)
    else:
        # ONE semantic authority for the object branch (_object_parts):
        # registry/whitelist, service tokens, custom encoders and the memo
        # all live there.
        parts = _object_parts(value)
        if isinstance(parts, bytes):  # memo hit / pre-encoded token
            out.extend(parts)
            return
        name_raw, fields, cacheable = parts
        start = len(out)
        out.append(_TAG_OBJECT)
        _write_varint(out, len(name_raw))
        out.extend(name_raw)
        _write_varint(out, len(fields))
        for f in fields:
            _encode(out, f)
        if cacheable:
            _memo_store(value, bytes(out[start:]))


_MAX_DEPTH = 64  # hostile nesting must exhaust this, not the Python stack


def _decode(data: bytes, pos: int, depth: int = 0) -> tuple[Any, int]:
    if depth > _MAX_DEPTH:
        raise DeserializationError("nesting too deep")
    if pos >= len(data):
        raise DeserializationError("truncated data")
    tag = data[pos]
    pos += 1
    if tag == _TAG_NONE:
        return None, pos
    if tag == _TAG_FALSE:
        return False, pos
    if tag == _TAG_TRUE:
        return True, pos
    if tag == _TAG_INT:
        n, pos = _read_varint(data, pos)
        return _unzigzag(n), pos
    if tag == _TAG_FLOAT:
        import math
        import struct as _struct

        if pos + 8 > len(data):
            raise DeserializationError("truncated float")
        (value,) = _struct.unpack(">d", data[pos:pos + 8])
        if not math.isfinite(value):
            raise DeserializationError("non-finite float")
        if value == 0.0 and data[pos] != 0:
            raise DeserializationError("non-canonical negative zero")
        return value, pos + 8
    if tag == _TAG_BYTES:
        n, pos = _read_varint(data, pos)
        if pos + n > len(data):
            raise DeserializationError("truncated bytes")
        return data[pos : pos + n], pos + n
    if tag == _TAG_STR:
        n, pos = _read_varint(data, pos)
        if pos + n > len(data):
            raise DeserializationError("truncated string")
        try:
            return data[pos : pos + n].decode("utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise DeserializationError(f"invalid utf-8 string: {e}") from e
    if tag == _TAG_LIST:
        n, pos = _read_varint(data, pos)
        if n > len(data) - pos:  # every item needs >= 1 byte: cheap DoS gate
            raise DeserializationError("collection count exceeds data")
        items = []
        for _ in range(n):
            item, pos = _decode(data, pos, depth + 1)
            items.append(item)
        return tuple(items), pos
    if tag == _TAG_DICT:
        n, pos = _read_varint(data, pos)
        if n > len(data) - pos:
            raise DeserializationError("collection count exceeds data")
        d = {}
        prev_kenc: bytes | None = None
        for _ in range(n):
            kstart = pos
            k, pos = _decode(data, pos, depth + 1)
            kenc = data[kstart:pos]
            v, pos = _decode(data, pos, depth + 1)
            # Canonicality: KEY encodings must arrive strictly increasing —
            # strictness on the key alone also rejects duplicate keys (a
            # duplicate with a larger value encoding would otherwise pass a
            # (key, value)-pair comparison), so distinct byte strings can
            # never decode to equal dicts.
            if prev_kenc is not None and kenc <= prev_kenc:
                raise DeserializationError("non-canonical dict entry order")
            prev_kenc = kenc
            try:
                d[k] = v
            except TypeError as e:  # unhashable key (e.g. a dict)
                raise DeserializationError(f"unhashable dict key: {e}") from e
        return d, pos
    if tag == _TAG_FROZENSET:
        n, pos = _read_varint(data, pos)
        if n > len(data) - pos:
            raise DeserializationError("collection count exceeds data")
        items = []
        prev_enc: bytes | None = None
        for _ in range(n):
            start = pos
            item, pos = _decode(data, pos, depth + 1)
            enc = data[start:pos]
            if prev_enc is not None and enc <= prev_enc:
                raise DeserializationError("non-canonical frozenset order")
            prev_enc = enc
            items.append(item)
        try:
            return frozenset(items), pos
        except TypeError as e:  # unhashable member (e.g. a dict)
            raise DeserializationError(f"unhashable set member: {e}") from e
    if tag == _TAG_OBJECT:
        n, pos = _read_varint(data, pos)
        if pos + n > len(data):
            raise DeserializationError("truncated wire name")
        try:
            wire_name = data[pos : pos + n].decode("utf-8")
        except UnicodeDecodeError as e:
            raise DeserializationError(f"invalid wire name: {e}") from e
        pos += n
        nfields, pos = _read_varint(data, pos)
        if nfields > len(data) - pos:
            raise DeserializationError("collection count exceeds data")
        values = []
        for _ in range(nfields):
            v, pos = _decode(data, pos, depth + 1)
            values.append(v)
        return _construct(wire_name, tuple(values)), pos
    raise DeserializationError(f"unknown tag 0x{tag:02x}")


def _construct(wire_name: str, values: tuple) -> Any:
    """Registry lookup + construction for a decoded object: the whitelist
    and construction semantics live in exactly one place."""
    if wire_name == "__svc_token__":
        from .tokens import current_token_context

        if len(values) != 1:
            raise DeserializationError("malformed service token")
        token_name = values[0]
        if not isinstance(token_name, str):
            # An unhashable/wrong-typed name must reject, not TypeError
            # out of the registry lookup.
            raise DeserializationError("service token name must be a string")
        ctx = current_token_context()
        if ctx is None:
            raise DeserializationError(
                f"service token {token_name!r} outside a TokenContext"
            )
        try:
            return ctx.resolve(token_name)
        except KeyError as e:
            raise DeserializationError(str(e)) from e
    cls = _BY_NAME.get(wire_name)
    if cls is None:
        raise DeserializationError(f"type {wire_name!r} is not whitelisted")
    dec = _CUSTOM_DEC.get(wire_name)
    if dec is not None:
        try:
            return dec(values)
        except Exception as e:  # malformed payloads must not crash callers
            raise DeserializationError(
                f"cannot decode {wire_name}: {e}") from e
    plan = _DEC_PLAN.get(wire_name)
    if plan is None:
        plan = _DEC_PLAN[wire_name] = (cls, tuple(
            (f.name, str(f.type).startswith(("list", "List")))
            for f in dataclasses.fields(cls)))
    _, field_plan = plan
    if len(values) != len(field_plan):
        raise DeserializationError(
            f"{wire_name}: expected {len(field_plan)} fields, "
            f"got {len(values)}"
        )
    kwargs = {}
    for (fname, is_list), v in zip(field_plan, values):
        # Tuples are the wire form of all sequences; convert back per the
        # declared field so list-typed fields round-trip.
        if is_list and isinstance(v, tuple):
            v = list(v)
        kwargs[fname] = v
    try:
        return cls(**kwargs)
    except Exception as e:  # malformed payloads must not crash callers
        raise DeserializationError(f"cannot construct {wire_name}: {e}") from e


@dataclasses.dataclass(frozen=True)
class SerializedBytes:
    """A typed wrapper over a serialized blob (reference: Kryo.kt:76-81)."""

    bytes: bytes

    @property
    def hash(self):
        from ..crypto.hashes import SecureHash

        return SecureHash.sha256(self.bytes)

    def deserialize(self) -> Any:
        return deserialize(self.bytes)

    def __len__(self) -> int:
        return len(self.bytes)


def serialize(value: Any) -> SerializedBytes:
    out = bytearray()
    _encode(out, value)
    return SerializedBytes(bytes(out))


def _object_parts(value: Any):
    """The object branch's single semantic authority (_encode's tail).
    Returns bytes to splice verbatim (memo hits, service tokens) OR
    (wire_name_bytes, fields_tuple, memoize_bool) for the caller to
    encode."""
    global SerializeAsToken, current_token_context
    if SerializeAsToken is None:  # lazy: .tokens imports this module
        from .tokens import SerializeAsToken, current_token_context
    if isinstance(value, SerializeAsToken):
        # Long-lived services become named tokens in checkpoints
        # (reference: SerializationToken.kt:25-133). Valid only inside an
        # active TokenContext. Encoded directly here (NOT via _encode,
        # whose object tail would recurse back into this function).
        ctx = current_token_context()
        if ctx is None:
            raise TypeError(
                f"{type(value).__qualname__} is a service token; it can "
                "only be serialized inside a checkpoint TokenContext"
            )
        out = bytearray()
        out.append(_TAG_OBJECT)
        raw = b"__svc_token__"
        _write_varint(out, len(raw))
        out.extend(raw)
        _write_varint(out, 1)
        _encode(out, value.token_name)
        return bytes(out)
    cls = type(value)
    cacheable = cls in _CACHEABLE
    if cacheable:
        # getattr, not value.__dict__: a __slots__ class has no instance
        # dict and must skip the memo on the read side too (the write
        # side already guards; round-3 advisor).
        cached = getattr(value, "_codec_enc", None)
        if cached is not None:
            return cached
    plan = _ENC_PLAN.get(cls)
    if plan is None:
        wire_name = _BY_TYPE.get(cls)
        if wire_name is None:
            raise TypeError(
                f"type {cls.__qualname__} is not registered for serialization")
        name_raw = wire_name.encode("utf-8")
        names = (() if cls in _CUSTOM_ENC else
                 tuple(f.name for f in dataclasses.fields(cls)))
        plan = _ENC_PLAN[cls] = (name_raw, names)
    name_raw, names = plan
    enc = _CUSTOM_ENC.get(cls)
    if enc is not None:
        fields = tuple(enc(value))
    else:
        fields = tuple(getattr(value, n) for n in names)
    return (name_raw, fields, cacheable)


def _memo_store(value: Any, enc: bytes) -> None:
    try:
        object.__setattr__(value, "_codec_enc", enc)
    except AttributeError:
        pass  # __slots__ types simply skip the memo


def deserialize(data: bytes | SerializedBytes) -> Any:
    raw = data.bytes if isinstance(data, SerializedBytes) else data
    value, pos = _decode(raw, 0)
    if pos != len(raw):
        raise DeserializationError(f"{len(raw) - pos} trailing bytes")
    return value


def serialized_hash(value: Any):
    """Hash of the canonical serialization — the Merkle leaf function
    (reference: MerkleTransaction.kt:35-38)."""
    from ..crypto.hashes import SecureHash

    return SecureHash(hashlib.sha256(serialize(value).bytes).digest())
