"""Proto3 messages declared by a table of fields, without protobuf.

The runtime under the port's table-driven codecs (so far
``ordering/fabric_codec.py``): :func:`message` makes a message class
from its fields, with the part of protobuf's Python message surface the
port's callers use: field attributes, ``add()``, ``append``/``extend``
on repeated fields, ``SerializeToString``, ``ParseFromString``,
``MergeFromString``, ``FromString``, ``CopyFrom``, ``MergeFrom``,
``HasField``, ``ClearField``, ``Clear``, ``SetInParent``, ``ByteSize``
and ``==``. It is written on the wire primitives of
:mod:`bdls_tpu_torch.utils.proto3`, because the machine that runs the
port on the card has no protobuf.

:meth:`Message.SerializeToString` writes the bytes protobuf writes, and
``ParseFromString`` accepts and refuses what protobuf's accepts and
refuses (:class:`DecodeError`):

- known fields in field-number order, then the unknown ones; a scalar
  equal to its default (0, ``False``, empty, a double whose bits are 0)
  is left out (proto3's implicit presence), so -0.0 is written;
- a message field is written when it is present, even empty: reading it
  does not make it present, setting any field in it (even to its
  default), appending to one of its lists, ``add()``, ``CopyFrom``,
  ``MergeFrom``, ``SetInParent`` or parsing into it does;
- an enum field is open, an int32 on the wire: a value the schema does
  not name is kept, and a negative one travels as ten bytes;
  ``int64`` likewise; ``uint32`` values read from a wider varint keep
  their low 32 bits; ``double`` is little-endian fixed64;
- a ``string`` must be valid UTF-8 on the wire;
- a scalar seen twice keeps the last value, a repeated field appends, a
  message seen twice merges the second into the first;
- unknown fields, and known ones under another wire type, are kept as
  their raw bytes, in the order read, and written back after the known
  fields, so a re-serialized block keeps its bytes;
- the members of a ``oneof`` group (the sixth item of a field's spec)
  exclude one another: making one present, by assignment, parsing or
  any of the ways above, clears the others (a message member that was
  present is cut loose from its parent; one only read stays linked, and
  changing it later makes it the member). A scalar member is present
  once assigned, even to its default, and is then written.
  ``WhichOneof`` names the present member, ``HasField`` and
  ``ClearField`` take a member's or the group's name;
- a nested enum (:func:`enum`, passed as ``enums``) is reachable on the
  message class, with each of its values (``RaftMessage.VOTE_REQ``).

Assignments are checked as protobuf checks them: ``TypeError`` for a
value of the wrong type (``bytes`` fields take ``bytes`` only, a
``string`` field takes ``str`` or UTF-8 ``bytes``), ``ValueError`` for
an integer out of its field's range; a message or repeated field cannot
be assigned.
"""

from __future__ import annotations

import struct

from enum import IntEnum

from bdls_tpu_torch.utils.proto3 import (SMALL, U32, U64, WT_I64, WT_LEN,
                                         WT_VARINT, DecodeError, read_tag,
                                         read_varint, skip, varint)

__all__ = [
    "DecodeError", "Message", "message", "enum", "ENUM", "INT64", "UINT32",
    "UINT64", "BOOL", "DOUBLE", "STRING", "BYTES", "MESSAGE",
    "RepeatedScalarContainer", "RepeatedCompositeContainer",
]

# field kinds
ENUM, INT64, UINT32, UINT64, BOOL, DOUBLE, STRING, BYTES, MESSAGE = range(9)
_I32_LO, _I32_HI = -(1 << 31), (1 << 31) - 1
_I64_LO, _I64_HI = -(1 << 63), (1 << 63) - 1
_RANGES = {ENUM: (_I32_LO, _I32_HI), INT64: (_I64_LO, _I64_HI),
           UINT32: (0, U32), UINT64: (0, U64)}
_DEFAULTS = {ENUM: 0, INT64: 0, UINT32: 0, UINT64: 0, BOOL: False,
             DOUBLE: 0.0, STRING: "", BYTES: b""}
_ZERO8 = b"\x00" * 8


def enum(name: str, values: dict, module: str) -> type:
    """An open enum of ``values`` (name → number) as an ``IntEnum`` with
    protobuf's ``EnumTypeWrapper`` lookups: ``Name`` and ``Value`` raise
    ``ValueError`` for what the schema does not name."""
    cls = IntEnum(name, values, module=module)

    def Name(number: int) -> str:
        try:
            return cls(number).name
        except ValueError:
            raise ValueError(f"{name} has no value {number}") from None

    def Value(key: str) -> int:
        try:
            return int(cls[key])
        except KeyError:
            raise ValueError(f"{name} has no value named {key!r}") from None

    cls.Name, cls.Value = staticmethod(Name), staticmethod(Value)
    cls.keys = staticmethod(lambda: [m.name for m in cls])
    cls.values = staticmethod(lambda: [int(m) for m in cls])
    cls.items = staticmethod(lambda: [(m.name, int(m)) for m in cls])
    return cls


class _Field:
    __slots__ = ("name", "number", "kind", "repeated", "cls", "key",
                 "tag", "default", "oneof")

    def __init__(self, name, number, kind, repeated=False, cls=None,
                 oneof=None):
        self.name, self.number, self.kind = name, number, kind
        self.repeated, self.cls, self.oneof = repeated, cls, oneof
        wt = {DOUBLE: WT_I64, STRING: WT_LEN, BYTES: WT_LEN,
              MESSAGE: WT_LEN}.get(kind, WT_VARINT)
        self.key = number << 3 | wt
        self.tag = varint(self.key)
        self.default = _DEFAULTS.get(kind)


def _check(f: _Field, v):
    """The value to store for an assignment of ``v`` to scalar field
    ``f`` (protobuf's type and range checks)."""
    k = f.kind
    if k == BYTES:
        if type(v) is not bytes:
            raise TypeError(
                f"{f.name}: expected bytes, {type(v).__name__} found")
        return v
    if k == STRING:
        if isinstance(v, str):
            try:
                v.encode("utf-8")
            except UnicodeEncodeError:
                raise ValueError(f"{f.name}: not valid UTF-8") from None
            return v
        if isinstance(v, bytes):
            return v.decode("utf-8")
        raise TypeError(f"{f.name}: expected str, {type(v).__name__} found")
    if k == DOUBLE:
        if isinstance(v, (int, float)):
            return float(v)
        raise TypeError(f"{f.name}: expected float, {type(v).__name__} found")
    if not isinstance(v, int):
        raise TypeError(f"{f.name}: expected int, {type(v).__name__} found")
    if k == BOOL:
        return bool(v)
    lo, hi = _RANGES[k]
    if not lo <= v <= hi:
        raise ValueError(f"{f.name}: value out of range: {v}")
    return int(v)


def _write_scalar(parts: list, f: _Field, v) -> None:
    k = f.kind
    if k == BYTES:
        n = len(v)
        parts += (f.tag, SMALL[n] if n < 0x80 else varint(n), v)
    elif k == STRING:
        b = v.encode("utf-8")
        n = len(b)
        parts += (f.tag, SMALL[n] if n < 0x80 else varint(n), b)
    elif k == DOUBLE:
        parts += (f.tag, struct.pack("<d", v))
    elif k == BOOL:
        parts += (f.tag, b"\x01" if v else b"\x00")
    else:
        parts += (f.tag, varint(v if v >= 0 else v + (1 << 64)))


# ---- repeated fields --------------------------------------------------------

class RepeatedScalarContainer:
    """A repeated ``string`` or ``bytes`` field: a list whose changes
    make the owning message present in its parent."""

    __slots__ = ("_items", "_owner", "_field")

    def __init__(self, owner: "Message", f: _Field):
        self._items: list = []
        self._owner, self._field = owner, f

    def _touch(self) -> None:
        if not self._owner._attached:
            self._owner._modified()

    def append(self, v) -> None:
        self._items.append(_check(self._field, v))
        self._touch()

    def extend(self, values) -> None:
        f = self._field
        self._items.extend([_check(f, v) for v in values])
        self._touch()

    def __setitem__(self, i, v) -> None:
        if isinstance(i, slice):
            self._items[i] = [_check(self._field, x) for x in v]
        else:
            self._items[i] = _check(self._field, v)
        self._touch()

    def __delitem__(self, i) -> None:
        del self._items[i]
        self._touch()

    def __getitem__(self, i):
        return self._items[i]

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __eq__(self, other) -> bool:
        if isinstance(other, RepeatedScalarContainer):
            return self._items == other._items
        return self._items == other

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._items)


class RepeatedCompositeContainer:
    """A repeated message field: ``add()`` makes a new element,
    ``append``/``extend`` add copies."""

    __slots__ = ("_items", "_owner", "_field")

    def __init__(self, owner: "Message", f: _Field):
        self._items: list = []
        self._owner, self._field = owner, f

    def _new(self) -> "Message":
        m = self._field.cls()
        m._parent = self._owner
        self._items.append(m)
        if not self._owner._attached:
            self._owner._modified()
        return m

    def add(self, **kwargs) -> "Message":
        m = self._new()
        for name, v in kwargs.items():
            m._set_init(name, v)
        return m

    def append(self, msg: "Message") -> None:
        if type(msg) is not self._field.cls:
            raise TypeError(f"{self._field.name}: expected "
                            f"{self._field.cls.__name__}")
        self._new().MergeFrom(msg)

    def extend(self, msgs) -> None:
        for msg in list(msgs):
            self.append(msg)

    def __delitem__(self, i) -> None:
        del self._items[i]
        if not self._owner._attached:
            self._owner._modified()

    def __getitem__(self, i):
        return self._items[i]

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __eq__(self, other) -> bool:
        return list(self._items) == list(other)

    __hash__ = None

    def __repr__(self) -> str:
        return repr(self._items)


# ---- messages ---------------------------------------------------------------

class Message:
    """The base of every message class. A message reached through a
    field of another (its parent) is present there once it is changed
    (``_attached``); a message made by its constructor is a root."""

    __slots__ = ("_v", "_unknown", "_parent", "_attached", "_pfield")
    FIELDS: tuple = ()
    _BY_NAME: dict = {}
    _BY_KEY: dict = {}
    _ONEOFS: dict = {}

    def __init__(self, **kwargs):
        self._v: dict = {}
        self._unknown = b""
        self._parent = None
        self._attached = True
        # the name of the field that holds this message in its parent
        self._pfield = None
        for name, v in kwargs.items():
            self._set_init(name, v)

    def _set_init(self, name: str, v) -> None:
        f = self._BY_NAME.get(name)
        if f is None:
            raise ValueError(
                f"{type(self).__name__} has no field named {name!r}")
        if f.repeated:
            getattr(self, name).extend(v)
        elif f.kind == MESSAGE:
            getattr(self, name).MergeFrom(v)
        else:
            setattr(self, name, v)

    def _modified(self) -> None:
        """Mark this message, and each parent up the chain, present."""
        m = self
        while not m._attached:
            m._attached = True
            p = m._parent
            if p is None:
                return
            if m._pfield is not None and p._BY_NAME[m._pfield].oneof:
                p._v[m._pfield] = m
                p._oneof_set(m._pfield)
            m = p

    def _oneof_set(self, name: str) -> None:
        """Member ``name`` of its group became present: clear the
        others. A message member that was present is cut loose; a stub
        only read keeps its link and can still become the member."""
        for other in self._ONEOFS[self._BY_NAME[name].oneof]:
            if other == name:
                continue
            x = self._v.pop(other, None)
            if isinstance(x, Message) and x._attached:
                x._parent = None

    # ---- encode ---------------------------------------------------------
    def _parts(self, parts: list) -> None:
        v = self._v
        for f in self.FIELDS:
            x = v.get(f.name)
            if x is None:
                continue
            if f.repeated:
                if f.kind == MESSAGE:
                    for m in x._items:
                        b = m.SerializeToString()
                        parts += (f.tag, varint(len(b)), b)
                else:
                    for item in x._items:
                        _write_scalar(parts, f, item)
            elif f.kind == MESSAGE:
                if x._attached:
                    b = x.SerializeToString()
                    parts += (f.tag, varint(len(b)), b)
            elif f.oneof:
                _write_scalar(parts, f, x)
            elif f.kind == DOUBLE:
                if struct.pack("<d", x) != _ZERO8:
                    _write_scalar(parts, f, x)
            elif x:
                _write_scalar(parts, f, x)
        if self._unknown:
            parts.append(self._unknown)

    def SerializeToString(self) -> bytes:
        parts: list = []
        self._parts(parts)
        return b"".join(parts)

    def ByteSize(self) -> int:
        return len(self.SerializeToString())

    # ---- decode ---------------------------------------------------------
    def _merge(self, buf: bytes, pos: int, end: int, depth: int) -> None:
        by_key = self._BY_KEY
        v = self._v
        unknown = []
        while pos < end:
            start = pos
            key = buf[pos]
            if key < 0x80:
                if key < 8:
                    raise DecodeError("field number 0")
                pos += 1
            else:
                key, pos = read_tag(buf, pos, end)
            f = by_key.get(key)
            if f is None:
                pos = skip(buf, pos, end, key >> 3, key & 7, depth)
                unknown.append(buf[start:pos])
                continue
            k = f.kind
            if key & 7 == WT_LEN:
                n = buf[pos] if pos < end else 0x80
                if n < 0x80:
                    pos += 1
                else:
                    n, pos = read_varint(buf, pos, end)
                stop = pos + n
                if stop > end:
                    raise DecodeError("truncated field")
                if k == BYTES:
                    val = buf[pos:stop]
                elif k == STRING:
                    try:
                        val = buf[pos:stop].decode("utf-8")
                    except UnicodeDecodeError:
                        raise DecodeError(
                            f"{f.name}: invalid UTF-8") from None
                elif f.repeated:
                    c = v.get(f.name)
                    if c is None:
                        c = v[f.name] = RepeatedCompositeContainer(self, f)
                    m = f.cls()
                    m._parent = self
                    m._merge(buf, pos, stop, depth + 1)
                    c._items.append(m)
                    pos = stop
                    continue
                else:
                    if f.oneof:
                        self._oneof_set(f.name)
                    m = getattr(self, f.name)
                    m._merge(buf, pos, stop, depth + 1)
                    m._attached = True
                    pos = stop
                    continue
                pos = stop
            elif k == DOUBLE:
                stop = pos + 8
                if stop > end:
                    raise DecodeError("truncated field")
                val = struct.unpack_from("<d", buf, pos)[0]
                pos = stop
            else:
                val, pos = read_varint(buf, pos, end)
                if k == ENUM:
                    val &= U32
                    if val >> 31:
                        val -= 1 << 32
                elif k == INT64:
                    if val >> 63:
                        val -= 1 << 64
                elif k == UINT32:
                    val &= U32
                elif k == BOOL:
                    val = val != 0
            if f.repeated:
                c = v.get(f.name)
                if c is None:
                    c = v[f.name] = RepeatedScalarContainer(self, f)
                c._items.append(val)
            else:
                if f.oneof:
                    self._oneof_set(f.name)
                v[f.name] = val
        if unknown:
            self._unknown += b"".join(unknown)

    def MergeFromString(self, data) -> int:
        if isinstance(data, str):
            raise TypeError("expected bytes, str found")
        buf = data if type(data) is bytes else bytes(data)
        self._merge(buf, 0, len(buf), 0)
        if not self._attached:
            self._modified()
        return len(buf)

    def ParseFromString(self, data) -> int:
        self.Clear()
        return self.MergeFromString(data)

    @classmethod
    def FromString(cls, data) -> "Message":
        m = cls()
        m.MergeFromString(data)
        return m

    # ---- whole-message operations ----------------------------------------
    def MergeFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"MergeFrom: expected {type(self).__name__}, "
                            f"{type(other).__name__} found")
        self.MergeFromString(other.SerializeToString())

    def CopyFrom(self, other: "Message") -> None:
        if other is self:
            return
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom: expected {type(self).__name__}, "
                            f"{type(other).__name__} found")
        data = other.SerializeToString()
        self.Clear()
        self.MergeFromString(data)

    def Clear(self) -> None:
        for x in self._v.values():
            if isinstance(x, Message):
                x._parent = None
                x._attached = True
        self._v = {}
        self._unknown = b""

    def SetInParent(self) -> None:
        if not self._attached:
            self._modified()

    def _present(self, f: _Field) -> bool:
        x = self._v.get(f.name)
        if f.kind == MESSAGE:
            return x is not None and x._attached
        return x is not None

    def WhichOneof(self, group: str):
        """The name of the member of ``group`` that is present, or
        None."""
        members = self._ONEOFS.get(group)
        if members is None:
            raise ValueError(
                f"{type(self).__name__} has no oneof named {group!r}")
        for name in members:
            if self._present(self._BY_NAME[name]):
                return name
        return None

    def HasField(self, name: str) -> bool:
        if name in self._ONEOFS:
            return self.WhichOneof(name) is not None
        f = self._BY_NAME.get(name)
        if f is None or f.repeated or (f.kind != MESSAGE and not f.oneof):
            raise ValueError(
                f"{type(self).__name__}.{name} has no presence to test")
        return self._present(f)

    def ClearField(self, name: str) -> None:
        if name in self._ONEOFS:
            name = self.WhichOneof(name)
            if name is None:
                return
        if name not in self._BY_NAME:
            raise ValueError(
                f"{type(self).__name__} has no field named {name!r}")
        x = self._v.pop(name, None)
        if isinstance(x, Message):
            x._parent = None
            x._attached = True

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return self.SerializeToString() == other.SerializeToString()

    __hash__ = None

    def __repr__(self) -> str:
        shown = []
        for f in self.FIELDS:
            x = self._v.get(f.name)
            if x is None:
                continue
            if f.repeated:
                if len(x):
                    shown.append(f"{f.name}={x!r}")
            elif f.kind == MESSAGE:
                if x._attached:
                    shown.append(f"{f.name}={x!r}")
            elif f.oneof or x != f.default:
                shown.append(f"{f.name}={x!r}")
        return f"{type(self).__name__}({', '.join(shown)})"


def _scalar_property(f: _Field):
    name, default = f.name, f.default

    def get(self):
        return self._v.get(name, default)

    def set(self, v):
        self._v[name] = _check(f, v)
        if f.oneof:
            self._oneof_set(name)
        if not self._attached:
            self._modified()

    return property(get, set)


def _message_property(f: _Field):
    name, cls = f.name, f.cls

    def get(self):
        m = self._v.get(name)
        if m is None:
            m = cls()
            m._parent = self
            m._attached = False
            m._pfield = name
            self._v[name] = m
        return m

    def set(self, v):
        raise AttributeError(
            f"assignment not allowed to message field {name!r}")

    return property(get, set)


def _repeated_property(f: _Field):
    name = f.name
    container = (RepeatedCompositeContainer if f.kind == MESSAGE
                 else RepeatedScalarContainer)

    def get(self):
        c = self._v.get(name)
        if c is None:
            c = self._v[name] = container(self, f)
        return c

    def set(self, v):
        raise AttributeError(
            f"assignment not allowed to repeated field {name!r}")

    return property(get, set)


def message(name: str, fields: list, module: str,
            enums: tuple = ()) -> type:
    """A message class named ``name`` of ``module`` with ``fields``:
    (name, number, kind[, repeated[, message class[, oneof group]]]) in
    field-number order, and the nested ``enums`` (:func:`enum`) with
    their values as class attributes."""
    fs = tuple(_Field(*spec) for spec in fields)
    oneofs: dict = {}
    for f in fs:
        if f.oneof:
            oneofs.setdefault(f.oneof, []).append(f.name)
    ns = {"__slots__": (), "FIELDS": fs,
          "_BY_NAME": {f.name: f for f in fs},
          "_BY_KEY": {f.key: f for f in fs},
          "_ONEOFS": {g: tuple(m) for g, m in oneofs.items()},
          "__module__": module, "__qualname__": name}
    for e in enums:
        ns[e.__name__] = e
        ns.update((m.name, m) for m in e)
    for f in fs:
        if f.repeated:
            ns[f.name] = _repeated_property(f)
        elif f.kind == MESSAGE:
            ns[f.name] = _message_property(f)
        else:
            ns[f.name] = _scalar_property(f)
    return type(name, (Message,), ns)

