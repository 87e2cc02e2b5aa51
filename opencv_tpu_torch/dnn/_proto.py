"""A protobuf codec of the port's own: the dnn readers parse ONNX, Caffe
and TensorFlow files with it, and no protobuf runtime is needed.

It is descriptor-driven.  ``_proto_files`` holds the serialized
``FileDescriptorProto`` of each schema; :func:`_load_all` decodes those
bytes with the small hand-written schema of ``descriptor.proto`` below (the
few fields of it that give every message's fields, numbers, types, labels,
defaults, oneofs and map entries) and makes one :class:`Message` subclass per
message type.  Their instances behave as the generated classes do where the
readers use them: attributes by field name with the schema's defaults,
repeated fields as lists with ``add``/``append``/``extend``, maps as dicts,
sub-messages created on first write, ``HasField``, ``WhichOneof``,
``ListFields``, the enum values as class attributes, and
``ParseFromString``/``SerializeToString`` of the binary wire format (varints,
zigzag, fixed32/64, packed repeated fields, nested messages, map entries).
:func:`parse_text` reads the text format (Caffe's ``.prototxt``, TF's
``.pbtxt``).

    onnx = schema("onnx_schema")
    m = onnx.ModelProto()
    m.ParseFromString(open("model.onnx", "rb").read())
"""

from __future__ import annotations

import re
import struct

import numpy as np

from ._proto_files import FILES

__all__ = ["Message", "schema", "parse_text", "DecodeError"]


class DecodeError(ValueError):
    pass


# wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5

# FieldDescriptorProto.Type
(T_DOUBLE, T_FLOAT, T_INT64, T_UINT64, T_INT32, T_FIXED64, T_FIXED32, T_BOOL, T_STRING,
 T_GROUP, T_MESSAGE, T_BYTES, T_UINT32, T_ENUM, T_SFIXED32, T_SFIXED64, T_SINT32,
 T_SINT64) = range(1, 19)
LABEL_REPEATED = 3

_VARINT_TYPES = {T_INT64, T_UINT64, T_INT32, T_BOOL, T_UINT32, T_ENUM, T_SINT32, T_SINT64}
_I64_FMT = {T_DOUBLE: "<d", T_FIXED64: "<Q", T_SFIXED64: "<q"}
_I32_FMT = {T_FLOAT: "<f", T_FIXED32: "<I", T_SFIXED32: "<i"}
_PACKED_NP = {T_FLOAT: "<f4", T_DOUBLE: "<f8", T_FIXED32: "<u4", T_SFIXED32: "<i4",
              T_FIXED64: "<u8", T_SFIXED64: "<i8"}
_INT_RANGE = {T_INT32: (-2 ** 31, 2 ** 31), T_SINT32: (-2 ** 31, 2 ** 31),
              T_SFIXED32: (-2 ** 31, 2 ** 31), T_UINT32: (0, 2 ** 32), T_FIXED32: (0, 2 ** 32),
              T_INT64: (-2 ** 63, 2 ** 63), T_SINT64: (-2 ** 63, 2 ** 63),
              T_SFIXED64: (-2 ** 63, 2 ** 63), T_UINT64: (0, 2 ** 64), T_FIXED64: (0, 2 ** 64),
              T_ENUM: (-2 ** 31, 2 ** 31)}


# ------------------------------------------------------------ wire format

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _iter_fields(buf, pos=0, end=None):
    """(number, wire type, value) of each field in buf[pos:end]: an int for
    a varint, fixed32 or fixed64 (the raw bits), a memoryview for a
    length-delimited field; groups are skipped."""
    end = len(buf) if end is None else end
    while pos < end:
        key, pos = _read_varint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _I64:
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wt == _LEN:
            n, pos = _read_varint(buf, pos)
            val = buf[pos:pos + n]
            if len(val) != n:
                raise DecodeError("truncated length-delimited field")
            pos += n
        elif wt == _I32:
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        elif wt == _SGROUP:
            pos = _skip_group(buf, pos, end, num)
            continue
        else:
            raise DecodeError(f"wire type {wt}")
        if pos > end:
            raise DecodeError("truncated field")
        yield num, wt, val


def _skip_group(buf, pos, end, num):
    while pos < end:
        key, pos = _read_varint(buf, pos)
        n, wt = key >> 3, key & 7
        if wt == _EGROUP:
            if n != num:
                raise DecodeError("mismatched group end")
            return pos
        if wt == _VARINT:
            _, pos = _read_varint(buf, pos)
        elif wt == _I64:
            pos += 8
        elif wt == _LEN:
            ln, pos = _read_varint(buf, pos)
            pos += ln
        elif wt == _I32:
            pos += 4
        elif wt == _SGROUP:
            pos = _skip_group(buf, pos, end, n)
    raise DecodeError("unterminated group")


def _signed64(v):
    return v - (1 << 64) if v >= 1 << 63 else v


def _scalar_from_wire(ftype, wt, raw):
    """A scalar field's Python value from one wire value."""
    if wt == _VARINT:
        if ftype in (T_INT32, T_INT64, T_ENUM):
            return _signed64(raw)
        if ftype in (T_SINT32, T_SINT64):
            return (raw >> 1) ^ -(raw & 1)
        if ftype == T_BOOL:
            return bool(raw)
        if ftype == T_UINT32:
            return raw & 0xFFFFFFFF
        return raw
    if wt == _I64:
        return struct.unpack(_I64_FMT[ftype], raw.to_bytes(8, "little"))[0]
    if wt == _I32:
        return struct.unpack(_I32_FMT[ftype], raw.to_bytes(4, "little"))[0]
    raise DecodeError(f"wire type {wt} for a field of type {ftype}")


def _wire_type(ftype):
    if ftype in _VARINT_TYPES:
        return _VARINT
    if ftype in _I64_FMT:
        return _I64
    if ftype in _I32_FMT:
        return _I32
    return _LEN


def _unpack(ftype, data):
    """The values of a packed repeated scalar field."""
    dt = _PACKED_NP.get(ftype)
    if dt is not None:
        return np.frombuffer(bytes(data), dt).tolist()
    out = []
    pos, end = 0, len(data)
    while pos < end:
        v, pos = _read_varint(data, pos)
        out.append(_scalar_from_wire(ftype, _VARINT, v))
    return out


def _varint(v):
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _scalar_to_wire(ftype, v):
    if ftype in (T_SINT32, T_SINT64):
        return _varint((v << 1) ^ (v >> 63))
    if ftype in _VARINT_TYPES:
        return _varint(int(v))
    if ftype in _I64_FMT:
        return struct.pack(_I64_FMT[ftype], v)
    if ftype in _I32_FMT:
        return struct.pack(_I32_FMT[ftype], v)
    if ftype == T_STRING:
        b = v.encode("utf-8")
        return _varint(len(b)) + b
    if ftype == T_BYTES:
        return _varint(len(v)) + bytes(v)
    raise TypeError(f"field type {ftype}")


# ------------------------------------------------------------ descriptors

def _raw(buf):
    """{field number: [wire values]} of one message (the bootstrap reader
    of descriptor.proto's messages)."""
    out = {}
    for num, _wt, val in _iter_fields(buf):
        out.setdefault(num, []).append(val)
    return out


def _s(raw, num, default=""):
    v = raw.get(num)
    return bytes(v[-1]).decode("utf-8") if v else default


def _i(raw, num, default=0):
    v = raw.get(num)
    return _signed64(v[-1]) if v else default


class EnumDescriptor:
    def __init__(self, name, full_name, values):
        self.name = name
        self.full_name = full_name
        self.values_by_name = dict(values)
        self.values_by_number = {}
        for k, v in values:
            self.values_by_number.setdefault(v, k)
        self.first = values[0][1] if values else 0


class FieldDescriptor:
    def __init__(self, raw, syntax):
        # FieldDescriptorProto: name 1, number 3, label 4, type 5,
        # type_name 6, default_value 7, options 8 (FieldOptions.packed 2),
        # oneof_index 9, proto3_optional 17
        self.name = _s(raw, 1)
        self.number = _i(raw, 3)
        self.label = _i(raw, 4, 1)
        self.type = _i(raw, 5)
        self.type_name = _s(raw, 6).lstrip(".")
        self.default_text = _s(raw, 7, None) if 7 in raw else None
        opts = _raw(raw[8][-1]) if 8 in raw else {}
        self.packed = bool(_i(opts, 2)) if 2 in opts else None
        self.oneof_index = _i(raw, 9) if 9 in raw else None
        self.proto3_optional = bool(_i(raw, 17))
        self.syntax = syntax
        self.oneof = None            # the oneof's name, set by the message
        self.message_type = None     # resolved after every file is read
        self.enum_type = None
        self.default = None

    @property
    def repeated(self):
        return self.label == LABEL_REPEATED

    @property
    def is_map(self):
        return self.message_type is not None and self.message_type.map_entry

    @property
    def has_presence(self):
        return (self.syntax != "proto3" or self.type == T_MESSAGE or self.oneof is not None
                or self.proto3_optional)

    def packs(self):
        """Whether a repeated field of this scalar type is written packed."""
        if self.type in (T_STRING, T_BYTES, T_MESSAGE, T_GROUP):
            return False
        if self.packed is not None:
            return self.packed
        return self.syntax == "proto3"

    def resolve_default(self):
        t = self.type
        txt = self.default_text
        if t == T_ENUM:
            e = self.enum_type
            self.default = e.values_by_name[txt] if txt is not None else (
                0 if self.syntax == "proto3" else e.first)
        elif t in (T_FLOAT, T_DOUBLE):
            v = float(txt) if txt is not None else 0.0
            self.default = _f32(v) if t == T_FLOAT else v
        elif t == T_BOOL:
            self.default = txt == "true"
        elif t == T_STRING:
            self.default = txt if txt is not None else ""
        elif t == T_BYTES:
            self.default = _unescape(txt).encode("latin-1") if txt is not None else b""
        elif t in (T_MESSAGE, T_GROUP):
            self.default = None
        else:
            self.default = int(txt) if txt is not None else 0


class MessageDescriptor:
    def __init__(self, raw, full_name, syntax):
        # DescriptorProto: name 1, field 2, nested_type 3, enum_type 4,
        # options 7 (MessageOptions.map_entry 7), oneof_decl 8
        self.name = _s(raw, 1)
        self.full_name = full_name
        self.syntax = syntax
        opts = _raw(raw[7][-1]) if 7 in raw else {}
        self.map_entry = bool(_i(opts, 7))
        oneofs = [_s(_raw(o), 1) for o in raw.get(8, [])]
        self.fields = [FieldDescriptor(_raw(f), syntax) for f in raw.get(2, [])]
        for f in self.fields:
            if f.oneof_index is not None and not f.proto3_optional:
                f.oneof = oneofs[f.oneof_index]
        self.fields_by_name = {f.name: f for f in self.fields}
        self.fields_by_number = {f.number: f for f in self.fields}
        self.oneofs = {o: [f.name for f in self.fields if f.oneof == o] for o in oneofs}
        self.nested = [MessageDescriptor(_raw(m), f"{full_name}.{_s(_raw(m), 1)}", syntax)
                       for m in raw.get(3, [])]
        self.enums = [_enum(_raw(e), full_name) for e in raw.get(4, [])]
        self.cls = None


def _enum(raw, scope):
    name = _s(raw, 1)
    values = [(_s(_raw(v), 1), _i(_raw(v), 2)) for v in raw.get(2, [])]
    return EnumDescriptor(name, f"{scope}.{name}" if scope else name, values)


_TYPES = {}       # full name -> MessageDescriptor or EnumDescriptor
_SCHEMAS = {}     # file key -> _Schema


class _Schema:
    """The top-level names of one schema file, as a generated module has
    them: message classes, enum values and enum wrappers."""

    def __init__(self, key):
        self.__name__ = key


class EnumWrapper:
    def __init__(self, desc):
        self.DESCRIPTOR = desc
        for k, v in desc.values_by_name.items():
            setattr(self, k, v)

    def Name(self, number):
        return self.DESCRIPTOR.values_by_number[number]

    def Value(self, name):
        return self.DESCRIPTOR.values_by_name[name]


def _walk(desc):
    yield desc
    for n in desc.nested:
        yield from _walk(n)


def _load_all():
    if _SCHEMAS:
        return
    files = []
    for key, data in FILES.items():
        raw = _raw(memoryview(data))
        # FileDescriptorProto: name 1, package 2, message_type 4,
        # enum_type 5, syntax 12
        pkg = _s(raw, 2)
        syntax = _s(raw, 12) or "proto2"
        msgs = [MessageDescriptor(_raw(m), f"{pkg}.{_s(_raw(m), 1)}" if pkg else _s(_raw(m), 1),
                                  syntax) for m in raw.get(4, [])]
        enums = [_enum(_raw(e), pkg) for e in raw.get(5, [])]
        for m in msgs:
            for d in _walk(m):
                _TYPES[d.full_name] = d
                for e in d.enums:
                    _TYPES[e.full_name] = e
        for e in enums:
            _TYPES[e.full_name] = e
        files.append((key, msgs, enums))
    for key, msgs, enums in files:
        for m in msgs:
            for d in _walk(m):
                for f in d.fields:
                    if f.type in (T_MESSAGE, T_GROUP):
                        f.message_type = _TYPES[f.type_name]
                    elif f.type == T_ENUM:
                        f.enum_type = _TYPES[f.type_name]
                    f.resolve_default()
    for key, msgs, enums in files:
        ns = _Schema(key)
        for m in msgs:
            setattr(ns, m.name, _make_class(m))
        for e in enums:
            setattr(ns, e.name, EnumWrapper(e))
            for k, v in e.values_by_name.items():
                setattr(ns, k, v)
        _SCHEMAS[key] = ns


def _make_class(desc):
    attrs = {"DESCRIPTOR": desc, "__slots__": ()}
    for e in desc.enums:
        attrs[e.name] = EnumWrapper(e)
        attrs.update(e.values_by_name)
    for n in desc.nested:
        attrs[n.name] = _make_class(n)
    cls = type(desc.name, (Message,), attrs)
    cls.__qualname__ = desc.full_name
    desc.cls = cls
    return cls


def schema(key: str) -> _Schema:
    """The namespace of one schema: ``"onnx_schema"``, ``"opencv_caffe"``,
    ``"graph"`` (TF's GraphDef), ``"attr_value"``, ``"tensor"``, ...;
    their message classes, nested classes and enum values by name."""
    _load_all()
    return _SCHEMAS[key]


# ------------------------------------------------------------ values

def _f32(v):
    return struct.unpack("<f", struct.pack("<f", v))[0]


def _coerce(f, v):
    t = f.type
    if t == T_FLOAT:
        return _f32(float(v))
    if t == T_DOUBLE:
        return float(v)
    if t == T_BOOL:
        return bool(v)
    if t == T_STRING:
        if isinstance(v, (bytes, bytearray)):
            return bytes(v).decode("utf-8")
        if not isinstance(v, str):
            raise TypeError(f"{f.name}: expected str, got {type(v).__name__}")
        return v
    if t == T_BYTES:
        if isinstance(v, str):
            raise TypeError(f"{f.name}: expected bytes, got str")
        return bytes(v)
    if t in (T_MESSAGE, T_GROUP):
        raise AttributeError(f"assignment to the message field {f.name}")
    if isinstance(v, (float, np.floating)) and not float(v).is_integer():
        raise TypeError(f"{f.name}: expected an integer, got {v!r}")
    iv = int(v)
    lo, hi = _INT_RANGE[t]
    if not lo <= iv < hi:
        raise ValueError(f"{f.name}: value {iv} out of range")
    return iv


class _Repeated(list):
    """A repeated scalar field: a list whose writes convert their values
    and mark the owning message present."""

    __slots__ = ("_owner", "_field")

    def __init__(self, owner, field, values=()):
        super().__init__(values)
        self._owner = owner
        self._field = field

    def append(self, v):
        super().append(_coerce(self._field, v))
        self._owner._mark()

    def extend(self, vs):
        super().extend(_coerce(self._field, v) for v in vs)
        self._owner._mark()

    def insert(self, i, v):
        super().insert(i, _coerce(self._field, v))
        self._owner._mark()

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            super().__setitem__(i, [_coerce(self._field, x) for x in v])
        else:
            super().__setitem__(i, _coerce(self._field, v))
        self._owner._mark()

    def add(self):
        raise AttributeError("add() on a repeated scalar field")


class _RepeatedFloats:
    """A repeated float or double field, held as one numpy array of its
    wire type (little-endian f4 or f8): a packed field decodes with one
    ``frombuffer`` and encodes with one ``tobytes``, and a reader takes it
    with ``np.asarray`` (``__array__``), so a weight blob never becomes a
    Python float per value.  It reads as a list of Python floats (len,
    iteration, indexing, ==); writes convert their values to the field's
    type and mark the owning message present."""

    __slots__ = ("_owner", "_field", "_dt", "_arr", "_tail")
    __hash__ = None

    def __init__(self, owner, field):
        self._owner = owner
        self._field = field
        self._dt = np.dtype(_PACKED_NP[field.type])
        self._arr = np.zeros(0, self._dt)
        self._tail = []     # single values appended since the last read

    def _array(self) -> np.ndarray:
        if self._tail:
            self._arr = np.concatenate([self._arr, np.asarray(self._tail, self._dt)])
            self._tail = []
        return self._arr

    def _load(self, a: np.ndarray) -> None:
        """Append the values `a` (already of the field's dtype)."""
        cur = self._array()
        self._arr = a if not len(cur) else np.concatenate([cur, a])

    def __array__(self, dtype=None, copy=None):
        a = self._array()
        return a.astype(dtype) if dtype is not None and a.dtype != dtype else a

    def __len__(self):
        return len(self._arr) + len(self._tail)

    def __iter__(self):
        return iter(self._array().tolist())

    def __getitem__(self, i):
        return self._array()[i].tolist()

    def __eq__(self, other):
        if isinstance(other, _RepeatedFloats):
            other = other._array()
        elif not isinstance(other, (list, tuple, np.ndarray)):
            return NotImplemented
        return list(self) == list(other)

    def __repr__(self):
        return repr(list(self))

    def append(self, v):
        self._tail.append(_coerce(self._field, v))
        self._owner._mark()

    def extend(self, vs):
        if isinstance(vs, (np.ndarray, _RepeatedFloats)):
            a = np.asarray(vs)
            if a.dtype.kind not in "biuf":
                raise TypeError(f"{self._field.name}: expected numbers, got {a.dtype}")
            self._load(a.ravel().astype(self._dt))
        else:
            self._tail.extend(_coerce(self._field, v) for v in vs)
        self._owner._mark()

    def _replace(self, values):
        self._arr = np.asarray(values, self._dt)
        self._tail = []
        self._owner._mark()

    def insert(self, i, v):
        vals = list(self)
        vals.insert(i, _coerce(self._field, v))
        self._replace(vals)

    def __setitem__(self, i, v):
        vals = list(self)
        if isinstance(i, slice):
            vals[i] = [_coerce(self._field, x) for x in v]
        else:
            vals[i] = _coerce(self._field, v)
        self._replace(vals)

    def add(self):
        raise AttributeError("add() on a repeated scalar field")


class _RepeatedMessage(list):
    __slots__ = ("_owner", "_field")

    def __init__(self, owner, field):
        super().__init__()
        self._owner = owner
        self._field = field

    def add(self, **kwargs):
        m = self._field.message_type.cls(**kwargs)
        super().append(m)
        self._owner._mark()
        return m

    def append(self, m):
        if not isinstance(m, self._field.message_type.cls):
            raise TypeError(f"{self._field.name}: expected {self._field.message_type.name}")
        super().append(m)
        self._owner._mark()

    def extend(self, ms):
        for m in ms:
            self.append(m)


class _Map(dict):
    """A map field: a dict; a missing key of a message-valued map reads as
    a new, stored value, as the generated classes do."""

    __slots__ = ("_owner", "_field", "_kf", "_vf")

    def __init__(self, owner, field):
        super().__init__()
        self._owner = owner
        self._field = field
        entry = field.message_type
        self._kf = entry.fields_by_number[1]
        self._vf = entry.fields_by_number[2]

    def __missing__(self, key):
        vf = self._vf
        v = vf.message_type.cls() if vf.type == T_MESSAGE else vf.default
        super().__setitem__(key, v)
        self._owner._mark()
        return v

    def __setitem__(self, key, v):
        if self._vf.type == T_MESSAGE:
            raise AttributeError("assignment to a message-valued map entry")
        super().__setitem__(_coerce(self._kf, key), _coerce(self._vf, v))
        self._owner._mark()


class Message:
    """The base of every message class :func:`schema` makes."""

    __slots__ = ("_v", "_lazy", "_parent", "_pname")
    DESCRIPTOR: MessageDescriptor

    def __init__(self, **kwargs):
        object.__setattr__(self, "_v", {})
        object.__setattr__(self, "_lazy", {})
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_pname", None)
        for k, v in kwargs.items():
            f = self._field(k)
            if f.repeated:
                getattr(self, k).extend(v)
            elif f.type == T_MESSAGE:
                getattr(self, k).CopyFrom(v)
            else:
                setattr(self, k, v)

    # -- presence
    def _mark(self):
        p = self._parent
        if p is not None:
            name = self._pname
            p._v[name] = self
            p._lazy.pop(name, None)
            p._clear_oneof(name)
            object.__setattr__(self, "_parent", None)
            p._mark()

    def _clear_oneof(self, name):
        f = self.DESCRIPTOR.fields_by_name[name]
        if f.oneof is not None:
            for other in self.DESCRIPTOR.oneofs[f.oneof]:
                if other != name:
                    self._v.pop(other, None)
                    self._lazy.pop(other, None)

    @classmethod
    def _field(cls, name):
        try:
            return cls.DESCRIPTOR.fields_by_name[name]
        except KeyError:
            raise AttributeError(f"{cls.DESCRIPTOR.name} has no field {name!r}") from None

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        f = self._field(name)
        v = self._v.get(name)
        if v is not None:
            return v
        if f.repeated:
            if f.is_map:
                v = _Map(self, f)
            elif f.type in (T_MESSAGE, T_GROUP):
                v = _RepeatedMessage(self, f)
            elif f.type in (T_FLOAT, T_DOUBLE):
                v = _RepeatedFloats(self, f)
            else:
                v = _Repeated(self, f)
            self._v[name] = v
            return v
        if f.type in (T_MESSAGE, T_GROUP):
            v = self._lazy.get(name)
            if v is None:
                v = f.message_type.cls()
                object.__setattr__(v, "_parent", self)
                object.__setattr__(v, "_pname", name)
                self._lazy[name] = v
            return v
        return f.default

    def __setattr__(self, name, value):
        f = self._field(name)
        if f.repeated:
            raise AttributeError(f"assignment to the repeated field {name}")
        self._v[name] = _coerce(f, value)
        self._clear_oneof(name)
        self._mark()

    def HasField(self, name):
        f = self._field(name)
        if f.repeated:
            raise ValueError(f"HasField on the repeated field {name}")
        if f.oneof is None and not f.has_presence:
            raise ValueError(f"{name} has no presence in {f.syntax}")
        return name in self._v

    def WhichOneof(self, oneof):
        for name in self.DESCRIPTOR.oneofs[oneof]:
            if name in self._v:
                return name
        return None

    def ClearField(self, name):
        self._field(name)
        self._v.pop(name, None)
        self._lazy.pop(name, None)

    def ListFields(self):
        """(descriptor, value) of each set field, by field number: repeated
        fields when not empty, proto3 scalars without presence when not
        their default."""
        out = []
        for f in sorted(self.DESCRIPTOR.fields, key=lambda f: f.number):
            if f.name not in self._v:
                continue
            v = self._v[f.name]
            if f.repeated:
                if len(v):
                    out.append((f, v))
            elif f.has_presence or v != f.default:
                out.append((f, v))
        return out

    def CopyFrom(self, other):
        if other is self:
            return
        self.Clear()
        self.MergeFrom(other)

    def MergeFrom(self, other):
        for f, v in other.ListFields():
            if f.is_map:
                dst = getattr(self, f.name)
                for k, x in v.items():
                    if f.message_type.fields_by_number[2].type == T_MESSAGE:
                        dst[k].MergeFrom(x)
                    else:
                        dst[k] = x
            elif f.repeated and f.type == T_MESSAGE:
                dst = getattr(self, f.name)
                for x in v:
                    dst.add().MergeFrom(x)
            elif f.repeated:
                getattr(self, f.name).extend(v)
            elif f.type == T_MESSAGE:
                sub = getattr(self, f.name)
                sub.MergeFrom(v)
                sub._mark()
            else:
                setattr(self, f.name, v)

    def Clear(self):
        self._v.clear()
        self._lazy.clear()

    def ParseFromString(self, data):
        self.Clear()
        _decode_into(self, memoryview(bytes(data)))
        self._mark()
        return len(data)

    def MergeFromString(self, data):
        _decode_into(self, memoryview(bytes(data)))
        self._mark()
        return len(data)

    @classmethod
    def FromString(cls, data):
        m = cls()
        m.ParseFromString(data)
        return m

    def SerializeToString(self):
        return _encode(self)

    def __eq__(self, other):
        if not isinstance(other, Message) or other.DESCRIPTOR is not self.DESCRIPTOR:
            return NotImplemented
        return _plain(self) == _plain(other)

    __hash__ = None

    def __repr__(self):
        return f"{self.DESCRIPTOR.name}({_plain(self)!r})"


def _plain(m):
    out = {}
    for f, v in m.ListFields():
        if f.is_map:
            out[f.name] = {k: _plain(x) if isinstance(x, Message) else x for k, x in v.items()}
        elif f.repeated and f.type == T_MESSAGE:
            out[f.name] = [_plain(x) for x in v]
        elif f.repeated:
            out[f.name] = list(v)
        elif f.type == T_MESSAGE:
            out[f.name] = _plain(v)
        else:
            out[f.name] = v
    return out


def _decode_into(msg, buf):
    desc = msg.DESCRIPTOR
    fields = desc.fields_by_number
    vals = msg._v
    for num, wt, raw in _iter_fields(buf):
        f = fields.get(num)
        if f is None:
            continue   # an unknown field: skipped
        name = f.name
        t = f.type
        if f.is_map:
            entry = f.message_type.cls()
            _decode_into(entry, raw)
            m = getattr(msg, name)
            kf = f.message_type.fields_by_number[1]
            vf = f.message_type.fields_by_number[2]
            key = entry._v.get(kf.name, kf.default)
            if vf.type == T_MESSAGE:
                dict.__setitem__(m, key, entry._v.get(vf.name) or vf.message_type.cls())
            else:
                dict.__setitem__(m, key, entry._v.get(vf.name, vf.default))
        elif t in (T_MESSAGE, T_GROUP):
            if wt != _LEN:
                raise DecodeError(f"{name}: wire type {wt} for a message")
            if f.repeated:
                sub = f.message_type.cls()
                _decode_into(sub, raw)
                list.append(getattr(msg, name), sub)
            else:
                sub = vals.get(name)
                if sub is None:
                    sub = f.message_type.cls()
                    msg._clear_oneof(name)
                    vals[name] = sub
                _decode_into(sub, raw)
        elif t == T_STRING or t == T_BYTES:
            if wt != _LEN:
                raise DecodeError(f"{name}: wire type {wt} for a string")
            v = bytes(raw).decode("utf-8") if t == T_STRING else bytes(raw)
            if f.repeated:
                list.append(getattr(msg, name), v)
            else:
                msg._clear_oneof(name)
                vals[name] = v
        elif f.repeated:
            rep = getattr(msg, name)
            if isinstance(rep, _RepeatedFloats):
                rep._load(np.frombuffer(bytes(raw), rep._dt) if wt == _LEN
                          else np.asarray([_scalar_from_wire(t, wt, raw)], rep._dt))
            elif wt == _LEN:
                list.extend(rep, _unpack(t, raw))
            else:
                list.append(rep, _scalar_from_wire(t, wt, raw))
        else:
            if wt == _LEN:
                raise DecodeError(f"{name}: a length-delimited value for a scalar")
            msg._clear_oneof(name)
            vals[name] = _scalar_from_wire(t, wt, raw)


def _tag(num, wt):
    return _varint((num << 3) | wt)


def _encode(msg):
    out = bytearray()
    for f, v in msg.ListFields():
        t = f.type
        if f.is_map:
            kf = f.message_type.fields_by_number[1]
            vf = f.message_type.fields_by_number[2]
            for k, x in v.items():
                body = _tag(1, _wire_type(kf.type)) + _scalar_to_wire(kf.type, k)
                if vf.type == T_MESSAGE:
                    sub = _encode(x)
                    body += _tag(2, _LEN) + _varint(len(sub)) + sub
                else:
                    body += _tag(2, _wire_type(vf.type)) + _scalar_to_wire(vf.type, x)
                out += _tag(f.number, _LEN) + _varint(len(body)) + body
        elif t in (T_MESSAGE, T_GROUP):
            for x in (v if f.repeated else (v,)):
                sub = _encode(x)
                out += _tag(f.number, _LEN) + _varint(len(sub)) + sub
        elif f.repeated and f.packs():
            body = (v._array().tobytes() if isinstance(v, _RepeatedFloats)
                    else b"".join(_scalar_to_wire(t, x) for x in v))
            out += _tag(f.number, _LEN) + _varint(len(body)) + body
        else:
            wt = _wire_type(t)
            for x in (v if f.repeated else (v,)):
                out += _tag(f.number, wt) + _scalar_to_wire(t, x)
    return bytes(out)


# ------------------------------------------------------------ text format

_TOKEN = re.compile(r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<str>"(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*')
  | (?P<num>[-+]?(?:0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)[fF]?)
  | (?P<ident>-?[A-Za-z_][\w.]*)
  | (?P<sym>[{}<>:\[\],;/])
""", re.VERBOSE)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'", '"': '"', "a": "\a",
            "b": "\b", "f": "\f", "v": "\v", "?": "?"}


def _unescape(s):
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        n = s[i + 1]
        if n in _ESCAPES:
            out.append(_ESCAPES[n])
            i += 2
        elif n in "xX":
            m = re.match(r"[0-9a-fA-F]{1,2}", s[i + 2:])
            out.append(chr(int(m.group(0), 16)))
            i += 2 + len(m.group(0))
        elif n in "01234567":
            m = re.match(r"[0-7]{1,3}", s[i + 1:])
            out.append(chr(int(m.group(0), 8)))
            i += 1 + len(m.group(0))
        else:
            raise DecodeError(f"bad escape \\{n}")
    return "".join(out)


def _tokens(text):
    pos = 0
    out = []
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise DecodeError(f"text format: cannot read {text[pos:pos + 20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind != "ws":
            out.append((kind, m.group(kind)))
    return out


class _TextParser:
    def __init__(self, text):
        self.toks = _tokens(text)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def take(self, want=None):
        tok = self.peek()
        if tok[0] is None or (want is not None and tok[1] != want):
            raise DecodeError(f"text format: expected {want!r}, got {tok[1]!r}")
        self.i += 1
        return tok

    def fields(self, msg, close):
        while True:
            kind, val = self.peek()
            if kind is None:
                if close is not None:
                    raise DecodeError("text format: unterminated message")
                return
            if kind == "sym" and val == close:
                self.i += 1
                return
            if kind == "sym" and val == "[":
                raise DecodeError("text format: extensions are not supported")
            self.field(msg)
            if self.peek()[1] in (",", ";"):
                self.i += 1

    def field(self, msg):
        _, name = self.take()
        f = msg.DESCRIPTOR.fields_by_name.get(name)
        if f is None:   # a group's field is named in lower case, its type not
            f = msg.DESCRIPTOR.fields_by_name.get(name.lower())
        if f is None:
            raise DecodeError(f"text format: {msg.DESCRIPTOR.name} has no field {name!r}")
        is_msg = f.type in (T_MESSAGE, T_GROUP)
        if self.peek()[1] == ":":
            self.i += 1
        elif not is_msg:
            raise DecodeError(f"text format: expected ':' after {name}")
        if self.peek()[1] == "[":
            self.i += 1
            if self.peek()[1] == "]":
                self.i += 1
                return
            while True:
                self.value(msg, f)
                if self.take()[1] == "]":
                    return
        else:
            self.value(msg, f)

    def value(self, msg, f):
        if f.type in (T_MESSAGE, T_GROUP):
            _, open_ = self.take()
            if open_ not in ("{", "<"):
                raise DecodeError(f"text format: expected '{{' for {f.name}")
            close = "}" if open_ == "{" else ">"
            if f.is_map:
                entry = f.message_type.cls()
                self.fields(entry, close)
                m = getattr(msg, f.name)
                kf = f.message_type.fields_by_number[1]
                vf = f.message_type.fields_by_number[2]
                key = entry._v.get(kf.name, kf.default)
                val = entry._v.get(vf.name, vf.message_type.cls() if vf.type == T_MESSAGE
                                   else vf.default)
                dict.__setitem__(m, key, val)
            elif f.repeated:
                self.fields(getattr(msg, f.name).add(), close)
            else:
                sub = getattr(msg, f.name)
                self.fields(sub, close)
                sub._mark()
            return
        kind, tok = self.take()
        t = f.type
        if t in (T_STRING, T_BYTES):
            if kind != "str":
                raise DecodeError(f"text format: expected a string for {f.name}")
            s = _unescape(tok[1:-1])
            while self.peek()[0] == "str":
                s += _unescape(self.take()[1][1:-1])
            v = s.encode("latin-1")
            v = v.decode("utf-8") if t == T_STRING else v
        elif t == T_ENUM:
            if kind == "ident":
                try:
                    v = f.enum_type.values_by_name[tok]
                except KeyError:
                    raise DecodeError(f"text format: {tok} is no value of "
                                      f"{f.enum_type.name}") from None
            else:
                v = int(tok, 0)
        elif t == T_BOOL:
            if tok in ("true", "True", "t", "1"):
                v = True
            elif tok in ("false", "False", "f", "0"):
                v = False
            else:
                raise DecodeError(f"text format: {tok!r} is no bool")
        elif t in (T_FLOAT, T_DOUBLE):
            low = tok.lower().lstrip("+")
            if low in ("inf", "infinity", "-inf", "-infinity", "nan", "-nan"):
                v = float(low.replace("infinity", "inf"))
            else:
                v = float(tok.rstrip("fF")) if not low.startswith(("0x", "-0x")) else float(
                    int(tok, 16))
        else:
            if kind != "num":
                raise DecodeError(f"text format: {tok!r} is no integer")
            v = int(tok, 0) if not re.search(r"[.eE]", tok.lstrip("0xX")) or tok.lower(
            ).startswith(("0x", "-0x")) else int(float(tok))
        if f.repeated:
            getattr(msg, f.name).append(v)
        else:
            setattr(msg, f.name, v)


def parse_text(text, msg):
    """Merge the text-format message `text` into `msg` (as
    ``google.protobuf.text_format.Parse`` does); returns `msg`."""
    _TextParser(text).fields(msg, None)
    msg._mark()
    return msg
