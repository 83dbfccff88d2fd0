"""The Arrow IPC *file* format, read and written by the port's own code (the
machine with the card has no ``pyarrow``).

``ArrowFile(path)`` memory-maps the file, checks the ``ARROW1`` magic at
both ends, reads the footer and its schema (FlatBuffers, through the small
table / vtable decoder below) and walks the record batches through the
footer's blocks; a message may carry the 0xFFFFFFFF continuation marker or
the older length-only prefix.  ``ArrowFile.column(name)`` is a ``Column``
whose rows span every record batch: ``column[i]`` is None for a null row
(validity bitmaps are read), ``int`` for the signed and unsigned ``Int``
widths, ``str`` for ``Utf8`` / ``LargeUtf8``, a ``memoryview`` slice of
the map for ``Binary`` / ``LargeBinary`` (no copy: the karpathy image pool
is hundreds of MB and is never read whole), and a list for ``List`` /
``LargeList`` of any of these.  Anything else raises ``ValueError`` naming
what it found: a compressed body, dictionary batches or a dictionary-encoded
field, a big-endian schema, a metadata version before V4, another type.

``write_arrow(path, columns, batch_rows)`` writes the same subset (one
``(type, values)`` pair per column, types named as ``TYPES`` lists them,
``list<...>`` / ``large_list<...>`` around one of them), 8-byte aligned,
with the continuation marker, for the smoke script and the tests.
"""
from __future__ import annotations

import mmap
import struct
from typing import NamedTuple, Optional

import numpy as np

MAGIC = b"ARROW1"
_CONTINUATION = 0xFFFFFFFF
_V4, _V5 = 3, 4                      # Schema.fbs MetadataVersion
_SCHEMA, _RECORD_BATCH = 1, 3       # Message.fbs MessageHeader
# Schema.fbs Type union ids
_T_INT, _T_BINARY, _T_UTF8, _T_LIST = 2, 4, 5, 12
_T_LARGE_BINARY, _T_LARGE_UTF8, _T_LARGE_LIST = 19, 20, 21
_TYPE_NAMES = {0: "NONE", 1: "Null", 2: "Int", 3: "FloatingPoint", 4: "Binary", 5: "Utf8",
               6: "Bool", 7: "Decimal", 8: "Date", 9: "Time", 10: "Timestamp", 11: "Interval",
               12: "List", 13: "Struct", 14: "Union", 15: "FixedSizeBinary",
               16: "FixedSizeList", 17: "Map", 18: "Duration", 19: "LargeBinary",
               20: "LargeUtf8", 21: "LargeList", 22: "RunEndEncoded", 23: "BinaryView",
               24: "Utf8View", 25: "ListView", 26: "LargeListView"}
TYPES = ("binary", "large_binary", "utf8", "large_utf8", "int8", "int16", "int32", "int64",
         "uint8", "uint16", "uint32", "uint64")


# ---------------------------------------------------------------------------
# FlatBuffers: tables through their vtables
# ---------------------------------------------------------------------------

class _Table:
    """A FlatBuffers table at ``pos`` of ``buf``."""

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        vt_size = struct.unpack_from("<H", buf, vt)[0]
        self._slots = struct.unpack_from(f"<{(vt_size - 4) // 2}H", buf, vt + 4)

    def _at(self, field: int) -> int:
        """The field's absolute position, 0 where the table lacks it."""
        off = self._slots[field] if field < len(self._slots) else 0
        return self.pos + off if off else 0

    def scalar(self, field: int, fmt: str, default=0):
        p = self._at(field)
        return struct.unpack_from("<" + fmt, self.buf, p)[0] if p else default

    def _target(self, field: int) -> int:
        p = self._at(field)
        return p + struct.unpack_from("<I", self.buf, p)[0] if p else 0

    def table(self, field: int) -> Optional["_Table"]:
        t = self._target(field)
        return _Table(self.buf, t) if t else None

    def string(self, field: int) -> Optional[str]:
        t = self._target(field)
        if not t:
            return None
        n = struct.unpack_from("<I", self.buf, t)[0]
        return bytes(self.buf[t + 4:t + 4 + n]).decode("utf-8")

    def tables(self, field: int) -> list:
        t = self._target(field)
        if not t:
            return []
        n = struct.unpack_from("<I", self.buf, t)[0]
        out = []
        for j in range(n):
            p = t + 4 + 4 * j
            out.append(_Table(self.buf, p + struct.unpack_from("<I", self.buf, p)[0]))
        return out

    def structs(self, field: int, fmt: str) -> list:
        """A vector of structs of ``fmt`` (little-endian, padding as 'x')."""
        t = self._target(field)
        if not t:
            return []
        n = struct.unpack_from("<I", self.buf, t)[0]
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, t + 4 + size * j) for j in range(n)]


def _root(buf) -> _Table:
    return _Table(buf, struct.unpack_from("<I", buf, 0)[0])


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _int_dtype(type_: str) -> np.dtype:
    """"int32" -> <i4, "uint8" -> <u1, ..."""
    signed = not type_.startswith("u")
    return np.dtype(f"<{'i' if signed else 'u'}{int(type_.removeprefix('u')[3:]) // 8}")


class Field(NamedTuple):
    name: str
    type: str                 # "binary", ..., "int32", "uint8", "list", "large_list"
    nullable: bool
    children: tuple


def _field(t: _Table) -> Field:
    name = t.string(0) or ""
    if t.table(4) is not None:
        raise ValueError(f"arrow field {name!r}: dictionary-encoded fields are not read")
    kind = t.scalar(2, "B")
    simple = {_T_BINARY: "binary", _T_LARGE_BINARY: "large_binary", _T_UTF8: "utf8",
              _T_LARGE_UTF8: "large_utf8", _T_LIST: "list", _T_LARGE_LIST: "large_list"}
    if kind == _T_INT:
        it = t.table(3)
        width, signed = it.scalar(0, "i"), bool(it.scalar(1, "B"))
        type_ = f"{'' if signed else 'u'}int{width}"
        if type_ not in TYPES:
            raise ValueError(f"arrow field {name!r}: Int of {width} bits")
    elif kind in simple:
        type_ = simple[kind]
    else:
        raise ValueError(f"arrow field {name!r}: type {_TYPE_NAMES.get(kind, kind)} is not read "
                         "(Binary, LargeBinary, Utf8, LargeUtf8, List, LargeList, Int)")
    children = tuple(_field(c) for c in t.tables(5))
    if type_ in ("list", "large_list") and len(children) != 1:
        raise ValueError(f"arrow field {name!r}: a list with {len(children)} children")
    return Field(name, type_, bool(t.scalar(1, "B")), children)


class _Chunk(NamedTuple):
    """One field's arrays in one record batch."""
    field: Field
    length: int
    validity: Optional[memoryview]
    offsets: Optional[np.ndarray]
    data: Optional[memoryview]
    values: Optional[np.ndarray]
    child: Optional["_Chunk"]

    def get(self, i: int):
        if self.validity is not None and not (self.validity[i >> 3] >> (i & 7)) & 1:
            return None
        kind = self.field.type
        if self.values is not None:
            return int(self.values[i])
        a, b = int(self.offsets[i]), int(self.offsets[i + 1])
        if kind in ("list", "large_list"):
            return [self.child.get(j) for j in range(a, b)]
        if kind in ("utf8", "large_utf8"):
            return str(self.data[a:b], "utf-8")
        return self.data[a:b]


class Column:
    """One column's rows across every record batch."""

    def __init__(self, chunks: list):
        self._chunks = chunks
        self._starts = np.cumsum([0] + [c.length for c in chunks])

    def __len__(self) -> int:
        return int(self._starts[-1])

    def __getitem__(self, i: int):
        n = len(self)
        if not -n <= i < n:
            raise IndexError(f"row {i} of a column of {n}")
        i %= n
        b = int(np.searchsorted(self._starts, i, side="right")) - 1
        return self._chunks[b].get(i - int(self._starts[b]))


class ArrowFile:
    """A memory-mapped Arrow IPC file (see the module docstring).  The map
    stays open while the object or a ``memoryview`` it handed out lives."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        buf = memoryview(self._map)
        n = len(buf)
        if n < 18 or bytes(buf[:6]) != MAGIC or bytes(buf[n - 6:]) != MAGIC:
            raise ValueError(f"{path}: not an Arrow IPC file (no ARROW1 magic at both ends)")
        flen = struct.unpack_from("<i", buf, n - 10)[0]
        if not 0 < flen <= n - 18:
            raise ValueError(f"{path}: footer of {flen} bytes in a file of {n}")
        footer = _root(buf[n - 10 - flen:n - 10])
        if footer.scalar(0, "h") < _V4:
            raise ValueError(f"{path}: metadata version {footer.scalar(0, 'h')} before V4")
        schema = footer.table(1)
        if schema is None:
            raise ValueError(f"{path}: the footer has no schema")
        if schema.scalar(0, "h") != 0:
            raise ValueError(f"{path}: a big-endian schema is not read")
        self.fields = [_field(t) for t in schema.tables(1)]
        # struct Block { offset: long; metaDataLength: int; (pad); bodyLength: long }
        if footer.structs(2, "qi4xq"):
            raise ValueError(f"{path}: dictionary batches are not read")
        self._batches = [self._batch(buf, *b) for b in footer.structs(3, "qi4xq")]
        self.num_rows = sum(length for length, _ in self._batches)
        self.num_batches = len(self._batches)

    def _batch(self, buf, offset: int, meta_len: int, body_len: int):
        """(rows, {name: _Chunk}) of the record batch at ``offset``."""
        first = struct.unpack_from("<I", buf, offset)[0]
        start = offset + (8 if first == _CONTINUATION else 4)
        size = struct.unpack_from("<i", buf, start - 4)[0]
        msg = _root(buf[start:start + size])
        if msg.scalar(1, "B") != _RECORD_BATCH:
            raise ValueError(f"{self.path}: block at {offset} holds message type "
                             f"{msg.scalar(1, 'B')}, not a record batch")
        rb = msg.table(2)
        if rb.table(3) is not None:
            raise ValueError(f"{self.path}: compressed record batches are not read")
        body = offset + meta_len
        if body + body_len > len(buf):
            raise ValueError(f"{self.path}: a record batch's body runs past the file's end")
        nodes = iter(rb.structs(1, "qq"))
        buffers = iter(rb.structs(2, "qq"))

        def take():
            off, length = next(buffers)
            if off < 0 or length < 0 or off + length > body_len:
                raise ValueError(f"{self.path}: a buffer outside its record batch's body")
            return buf[body + off:body + off + length]

        def chunk(field: Field) -> _Chunk:
            length, nulls = next(nodes)
            valid = take()
            validity = valid if nulls and len(valid) else None
            offsets = data = values = child = None
            if field.type.startswith(("int", "uint")):
                values = np.frombuffer(take(), _int_dtype(field.type), count=length)
            else:
                dt = "<i8" if field.type.startswith("large") else "<i4"
                raw = take()
                offsets = (np.frombuffer(raw, dt, count=length + 1) if length
                           else np.zeros(1, dt))
                if field.type.endswith("list"):
                    child = chunk(field.children[0])
                else:
                    data = take()
            return _Chunk(field, length, validity, offsets, data, values, child)

        return rb.scalar(0, "q"), {f.name: chunk(f) for f in self.fields}

    @property
    def names(self) -> list:
        return [f.name for f in self.fields]

    def column(self, name: str) -> Column:
        if name not in self.names:
            raise KeyError(f"{self.path}: no column {name!r} (have {self.names})")
        return Column([chunks[name] for _, chunks in self._batches])

    def __len__(self) -> int:
        return self.num_rows


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

class _Obj:
    """A FlatBuffers object to emit: a table (``fields``: field id ->
    (format, value) for a scalar or ("off", _Obj)), a string, a vector of
    structs (``raw`` bytes of ``count`` elements aligned to ``align``) or a
    vector of objects."""

    def __init__(self, kind, value, count=0, align=4):
        self.kind, self.value, self.count, self.align = kind, value, count, align


def _emit(root: _Obj) -> bytes:
    """The objects laid out forward from the root (every uoffset points to
    a later position), each scalar aligned to its size in the buffer."""
    out = bytearray(4)
    todo = [(0, root)]                  # (position of the uoffset to patch, object)

    def pad(align, extra=0):
        out.extend(b"\0" * ((-(len(out) + extra)) % align))

    while todo:
        ref, obj = todo.pop(0)
        if obj.kind == "table":
            slots = max(obj.value, default=-1) + 1
            pad(2)
            vt = len(out)
            out.extend(b"\0" * (4 + 2 * slots))
            pad(4)
            pos = len(out)
            out.extend(struct.pack("<i", pos - vt))
            offsets = {}
            for fid, (fmt, val) in sorted(obj.value.items()):
                size = 4 if fmt == "off" else struct.calcsize("<" + fmt)
                pad(size)
                offsets[fid] = len(out) - pos
                if fmt == "off":
                    todo.append((len(out), val))
                    out.extend(b"\0\0\0\0")
                else:
                    out.extend(struct.pack("<" + fmt, val))
            struct.pack_into("<HH", out, vt, 4 + 2 * slots, len(out) - pos)
            for fid, off in offsets.items():
                struct.pack_into("<H", out, vt + 4 + 2 * fid, off)
        elif obj.kind == "string":
            pad(4)
            pos = len(out)
            data = obj.value.encode("utf-8")
            out.extend(struct.pack("<I", len(data)) + data + b"\0")
        elif obj.kind == "structs":
            pad(max(obj.align, 4), 4)
            pos = len(out)
            out.extend(struct.pack("<I", obj.count) + obj.value)
        else:                             # a vector of objects
            pad(4)
            pos = len(out)
            out.extend(struct.pack("<I", len(obj.value)))
            for child in obj.value:
                todo.append((len(out), child))
                out.extend(b"\0\0\0\0")
        struct.pack_into("<I", out, ref, pos - ref)
    return bytes(out)


def _table(**fields) -> _Obj:
    return _Obj("table", {int(k[1:]): v for k, v in fields.items()})


def _parse_type(spec: str):
    """A column type name -> (Field-building info): (type id, int spec or
    None, child spec or None)."""
    for outer, tid in (("large_list<", _T_LARGE_LIST), ("list<", _T_LIST)):
        if spec.startswith(outer) and spec.endswith(">"):
            return tid, None, spec[len(outer):-1]
    simple = {"binary": _T_BINARY, "large_binary": _T_LARGE_BINARY, "utf8": _T_UTF8,
              "large_utf8": _T_LARGE_UTF8}
    if spec in simple:
        return simple[spec], None, None
    if spec in TYPES:
        return _T_INT, (_int_dtype(spec).itemsize * 8, not spec.startswith("u")), None
    raise ValueError(f"write_arrow: type {spec!r} (one of {TYPES} or list<...> of one)")


def _field_obj(name: str, spec: str) -> _Obj:
    tid, int_spec, child = _parse_type(spec)
    type_table = (_table(f0=("i", int_spec[0]), f1=("B", int(int_spec[1]))) if int_spec
                  else _table())
    children = [_field_obj("item", child)] if child else []
    return _table(f0=("off", _Obj("string", name)), f1=("B", 1), f2=("B", tid),
                  f3=("off", type_table), f5=("off", _Obj("vector", children)))


def _schema_obj(columns) -> _Obj:
    return _table(f0=("h", 0), f1=("off", _Obj("vector", [_field_obj(n, s)
                                                          for n, (s, _) in columns.items()])))


def _structs(rows, fmt) -> _Obj:
    return _Obj("structs", b"".join(struct.pack("<" + fmt, *r) for r in rows), len(rows), 8)


def _arrays(spec: str, values: list, nodes: list, bufs: list):
    """Append the field's node and buffers (depth first) for ``values``."""
    tid, int_spec, child = _parse_type(spec)
    n = len(values)
    nulls = sum(v is None for v in values)
    nodes.append((n, nulls))
    if nulls:
        bits = np.zeros(-(-n // 8) * 8, np.uint8)
        bits[:n] = [v is not None for v in values]
        bufs.append(np.packbits(bits, bitorder="little").tobytes())
    else:
        bufs.append(b"")
    if int_spec:
        bufs.append(np.array([0 if v is None else v for v in values],
                             _int_dtype(spec)).tobytes())
        return
    large = tid in (_T_LARGE_BINARY, _T_LARGE_UTF8, _T_LARGE_LIST)
    if child is not None:
        items = [x for v in values if v is not None for x in v]
        sizes = [0 if v is None else len(v) for v in values]
    else:
        items = [b"" if v is None else (v.encode("utf-8") if isinstance(v, str) else bytes(v))
                 for v in values]
        sizes = [len(x) for x in items]
    bufs.append(np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]).astype(
        "<i8" if large else "<i4").tobytes())
    if child is not None:
        _arrays(child, items, nodes, bufs)
    else:
        bufs.append(b"".join(items))


def _message(header_type: int, header: _Obj, body_len: int) -> bytes:
    fb = _emit(_table(f0=("h", _V5), f1=("B", header_type), f2=("off", header),
                      f3=("q", body_len)))
    fb += b"\0" * ((-len(fb)) % 8)
    return struct.pack("<Ii", _CONTINUATION, len(fb)) + fb


def write_arrow(path: str, columns: dict, batch_rows: Optional[int] = None) -> None:
    """``columns``: {name: (type, values)} of equal lengths -> an Arrow IPC
    file of record batches of ``batch_rows`` rows (all in one when None).
    Values may be None (a null row)."""
    lengths = {len(v) for _, v in columns.values()}
    if len(lengths) != 1:
        raise ValueError(f"write_arrow: columns of lengths {sorted(lengths)}")
    n = lengths.pop()
    step = batch_rows or max(n, 1)
    out = bytearray(MAGIC + b"\0\0")
    out += _message(_SCHEMA, _schema_obj(columns), 0)
    blocks = []
    for lo in range(0, max(n, 1), step):
        nodes, bufs = [], []
        for spec, values in columns.values():
            _arrays(spec, list(values[lo:lo + step]), nodes, bufs)
        body, layout = bytearray(), []
        for b in bufs:
            layout.append((len(body), len(b)))
            body += b + b"\0" * ((-len(b)) % 8)
        rows = min(step, n - lo)
        meta = _message(_RECORD_BATCH, _table(f0=("q", rows), f1=("off", _structs(nodes, "qq")),
                                              f2=("off", _structs(layout, "qq"))), len(body))
        blocks.append((len(out), len(meta), len(body)))
        out += meta + body
    footer = _emit(_table(f0=("h", _V5), f1=("off", _schema_obj(columns)),
                          f2=("off", _structs([], "qi4xq")),
                          f3=("off", _structs(blocks, "qi4xq"))))
    out += footer + struct.pack("<i", len(footer)) + MAGIC
    with open(path, "wb") as f:
        f.write(out)
