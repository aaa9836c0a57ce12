"""An HDF5 reader and writer of the port's own, on numpy, `struct` and the
standard library: the `.h5` weight files of Keras and of the JAX package's
`export_h5` read and write wherever the port runs, with or without h5py.

The subset is the one those writers use (HDF5 file format specification
3.0):

  read   superblock versions 0-3 (2 and 3 with their checksum); object
         headers version 1 and 2 (OHDR / OCHK, Jenkins lookup3 checksum)
         with continuation blocks; old-style groups (symbol-table message,
         version-1 B-tree of SNOD nodes over a local heap, any depth) and
         compact new-style groups (link messages); dataspaces version 1
         and 2 (simple, scalar, null); datatypes fixed-point, IEEE float
         (either byte order), fixed-length string and variable-length
         string (global heap); data layout versions 3 and 4, compact and
         contiguous (an unallocated dataset reads as its fill value, else
         zeros); attribute messages versions 1-3.
  write  what h5py writes at its defaults: superblock v0 with 8-byte
         offsets and lengths, version-1 object headers, old-style groups
         with sorted names over as many 8-entry SNODs as needed,
         contiguous little-endian datasets with a fill-value message,
         fixed-length null-padded ASCII string attributes (array or scalar)
         and numeric attributes.

Messages the reader does not need (fill value of an allocated dataset,
modification time, group info, a filter pipeline on a dataset that is not
chunked, ...) are skipped. What it cannot read raises ValueError naming the
file, the object's path and the structure: chunked or filtered data, dense
link or attribute storage (a fractal heap), shared messages, external
storage, and any other datatype class. A file is read whole or not at all.
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["read_h5", "write_h5", "lookup3"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_M32 = 0xFFFFFFFF

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE = 0x01, 0x02, 0x03
_FILL, _LINK, _EXTERNAL = 0x05, 0x06, 0x07
_LAYOUT, _ATTRIBUTE = 0x08, 0x0C
_CONTINUATION, _SYMBOL_TABLE, _ATTR_INFO = 0x10, 0x11, 0x15

# group B-tree and symbol-table node geometry the writer uses (h5py's)
_LEAF_K, _INTERNAL_K = 4, 16


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 `hashlittle`, the checksum of HDF5's version-2
    structures."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    k = 0
    while n > 12:
        a = (a + int.from_bytes(data[k:k + 4], "little")) & _M32
        b = (b + int.from_bytes(data[k + 4:k + 8], "little")) & _M32
        c = (c + int.from_bytes(data[k + 8:k + 12], "little")) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32    # noqa: E702
        b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32    # noqa: E702
        c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32    # noqa: E702
        a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32   # noqa: E702
        b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32   # noqa: E702
        c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32    # noqa: E702
        n -= 12
        k += 12
    if n == 0:
        return c
    tail = bytes(data[k:k + n]) + bytes(12 - n)
    a = (a + int.from_bytes(tail[0:4], "little")) & _M32
    b = (b + int.from_bytes(tail[4:8], "little")) & _M32
    c = (c + int.from_bytes(tail[8:12], "little")) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32    # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & _M32    # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & _M32    # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & _M32    # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & _M32     # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & _M32    # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & _M32    # noqa: E702
    return c


def _align8(n: int) -> int:
    return (n + 7) & ~7


# -- reading ------------------------------------------------------------------

class _Reader:
    """One file's bytes and the parsing of its structures. Every fault
    raises ValueError through `fail`, naming the file and the object."""

    def __init__(self, path):
        self.path = str(path)
        with open(path, "rb") as f:
            self.buf = memoryview(f.read())
        if bytes(self.buf[:8]) != _SIGNATURE:
            raise ValueError(f"{self.path}: not an HDF5 file (no superblock "
                             f"signature at offset 0)")
        self.gcol: dict = {}
        self._superblock()

    def fail(self, obj: str, what: str):
        raise ValueError(f"{self.path}: object {'/' + obj!r}: {what}")

    # fields ------------------------------------------------------------------

    def u(self, pos: int, n: int) -> int:
        if pos < 0 or pos + n > len(self.buf):
            raise ValueError(f"{self.path}: a structure runs past the end of "
                             f"the file (offset {pos}, {n} bytes)")
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def bytes_at(self, pos: int, n: int, obj: str, what: str) -> bytes:
        if pos < 0 or pos + n > len(self.buf):
            self.fail(obj, f"{what} runs past the end of the file")
        return bytes(self.buf[pos:pos + n])

    def undefined(self, addr: int) -> bool:
        return addr == (1 << (8 * self.so)) - 1

    def checksum(self, start: int, end: int, obj: str, what: str):
        want = self.u(end, 4)
        got = lookup3(self.bytes_at(start, end - start, obj, what))
        if got != want:
            self.fail(obj, f"{what} checksum mismatch (stored {want:#010x}, "
                           f"computed {got:#010x})")

    # superblock --------------------------------------------------------------

    def _superblock(self):
        b = self.buf
        version = b[8]
        if version in (0, 1):
            self.so, self.sl = b[13], b[14]
            pos = 24 + (4 if version == 1 else 0)
            root_entry = pos + 4 * self.so
            self.root = self.u(root_entry + self.so, self.so)
        elif version in (2, 3):
            self.so, self.sl = b[9], b[10]
            self.root = self.u(12 + 3 * self.so, self.so)
            self.checksum(0, 12 + 4 * self.so, "", f"superblock v{version}")
        else:
            raise ValueError(f"{self.path}: superblock version {version} is "
                             f"not supported")
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise ValueError(f"{self.path}: superblock sizes of offsets "
                             f"{self.so} / lengths {self.sl} not supported")

    # object headers ----------------------------------------------------------

    def messages(self, addr: int, obj: str) -> list:
        """All messages of the object header at `addr`, continuation blocks
        included, as (type, flags, bytes)."""
        b = self.buf
        out = []
        seen = set()

        def block(off):  # a continuation block, each read once
            if off in seen:
                self.fail(obj, "object header continuation cycle")
            seen.add(off)
            return off
        if self.bytes_at(addr, 4, obj, "object header") == b"OHDR":
            version, flags = b[addr + 4], b[addr + 5]
            if version != 2:
                self.fail(obj, f"object header OHDR version {version}")
            pos = addr + 6 + (16 if flags & 0x20 else 0) + (
                4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            size0 = self.u(pos, width)
            start = pos + width
            chunks = [(start, start + size0, addr)]
            hdr = 6 if flags & 0x04 else 4
            while chunks:
                start, end, csum_from = chunks.pop(0)
                self.checksum(csum_from, end, obj, "object header chunk")
                pos = start
                while end - pos >= hdr:
                    mtype, msize, mflags = b[pos], self.u(pos + 1, 2), \
                        b[pos + 3]
                    body = pos + hdr
                    if body + msize > end:
                        self.fail(obj, "object header message runs past "
                                       "its chunk")
                    data = bytes(b[body:body + msize])
                    if mtype == _CONTINUATION:
                        off = int.from_bytes(data[:self.so], "little")
                        ln = int.from_bytes(
                            data[self.so:self.so + self.sl], "little")
                        if self.bytes_at(off, 4, obj, "continuation") != \
                                b"OCHK":
                            self.fail(obj, "continuation block without the "
                                           "OCHK signature")
                        chunks.append((block(off) + 4, off + ln - 4, off))
                    out.append((mtype, mflags, data))
                    pos = body + msize
            return out
        version = b[addr]
        if version != 1:
            self.fail(obj, f"object header version {version}")
        size0 = self.u(addr + 8, 4)
        chunks = [(addr + 16, addr + 16 + size0)]
        while chunks:
            pos, end = chunks.pop(0)
            while end - pos >= 8:
                mtype, msize, mflags = self.u(pos, 2), self.u(pos + 2, 2), \
                    b[pos + 4]
                body = pos + 8
                if body + msize > end:
                    self.fail(obj, "object header message runs past its "
                                   "chunk")
                data = bytes(b[body:body + msize])
                if mtype == _CONTINUATION:
                    off = int.from_bytes(data[:self.so], "little")
                    ln = int.from_bytes(data[self.so:self.so + self.sl],
                                        "little")
                    chunks.append((block(off), off + ln))
                out.append((mtype, mflags, data))
                pos = body + msize
        return out

    # groups ------------------------------------------------------------------

    def heap_name(self, heap_data: int, heap_size: int, off: int,
                  obj: str) -> bytes:
        if off >= heap_size:
            self.fail(obj, f"local heap offset {off} past its data segment")
        raw = self.bytes_at(heap_data + off, heap_size - off, obj,
                            "local heap name")
        return raw.split(b"\0", 1)[0]

    def symbol_table_links(self, data: bytes, obj: str) -> list:
        """(name, object header address) of an old-style group: the v1
        B-tree's SNOD leaves over the local heap's names."""
        so, sl = self.so, self.sl
        btree = int.from_bytes(data[:so], "little")
        heap = int.from_bytes(data[so:2 * so], "little")
        if self.bytes_at(heap, 4, obj, "local heap") != b"HEAP":
            self.fail(obj, "local heap without the HEAP signature")
        heap_size = self.u(heap + 8, sl)
        heap_data = self.u(heap + 8 + 2 * sl, so)
        links = []

        def node(addr, depth):
            if depth > 64:
                self.fail(obj, "group B-tree deeper than 64 levels")
            if self.bytes_at(addr, 4, obj, "group B-tree node") != b"TREE":
                self.fail(obj, "group B-tree node without the TREE "
                               "signature")
            ntype, level, used = self.buf[addr + 4], self.buf[addr + 5], \
                self.u(addr + 6, 2)
            if ntype != 0:
                self.fail(obj, f"group B-tree node of type {ntype}")
            pos = addr + 8 + 2 * so + sl  # past the siblings and key 0
            for _ in range(used):
                child = self.u(pos, so)
                pos += so + sl
                if level:
                    node(child, depth + 1)
                else:
                    snod(child)

        def snod(addr):
            if self.bytes_at(addr, 4, obj, "symbol-table node") != b"SNOD":
                self.fail(obj, "symbol-table node without the SNOD "
                               "signature")
            n = self.u(addr + 6, 2)
            pos = addr + 8
            for _ in range(n):
                name_off = self.u(pos, so)
                ohdr = self.u(pos + so, so)
                cache = self.u(pos + 2 * so, 4)
                pos += 2 * so + 24
                if cache == 2:  # a soft link: no object of its own
                    continue
                links.append((self.heap_name(heap_data, heap_size, name_off,
                                             obj), ohdr))

        node(btree, 0)
        return links

    def link(self, data: bytes, obj: str):
        """(name, address) of a hard link message, None for soft and
        external links (not objects)."""
        flags = data[1]
        pos = 2
        ltype = 0
        if flags & 0x08:
            ltype = data[pos]
            pos += 1
        if flags & 0x04:
            pos += 8
        if flags & 0x10:
            pos += 1
        width = 1 << (flags & 3)
        nlen = int.from_bytes(data[pos:pos + width], "little")
        pos += width
        name = bytes(data[pos:pos + nlen])
        pos += nlen
        if ltype != 0:
            return None
        return name, int.from_bytes(data[pos:pos + self.so], "little")

    # datatypes, dataspaces, data ---------------------------------------------

    def datatype(self, d: bytes, obj: str) -> tuple:
        """('num', dtype) | ('str', size, charset) | ('vlen', charset)."""
        cls, bits, size = d[0] & 0x0F, d[1] | d[2] << 8 | d[3] << 16, \
            int.from_bytes(d[4:8], "little")
        order = ">" if bits & 1 else "<"
        if cls == 0:
            prec = int.from_bytes(d[10:12], "little")
            if size not in (1, 2, 4, 8) or prec != 8 * size or \
                    int.from_bytes(d[8:10], "little"):
                self.fail(obj, f"fixed-point datatype of {size} bytes with "
                               f"{prec} bits of precision")
            kind = "i" if bits & 0x08 else "u"
            return "num", np.dtype(f"{order}{kind}{size}")
        if cls == 1:
            std = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
                   8: (63, 52, 11, 0, 52, 1023)}
            sign = (bits >> 8) & 0xFF
            props = d[8:20]
            layout = (sign, props[4], props[5], props[6], props[7],
                      int.from_bytes(props[8:12], "little"))
            if bits & 0x40 or std.get(size) != layout:
                self.fail(obj, f"floating-point datatype of {size} bytes "
                               f"that is not IEEE 754 binary{8 * size}")
            return "num", np.dtype(f"{order}f{size}")
        if cls == 3:
            return "str", size, (bits >> 4) & 0x0F
        if cls == 9 and (bits & 0x0F) == 1:
            return "vlen", (bits >> 8) & 0x0F
        what = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 9: "variable-length sequence",
                10: "array"}.get(cls, "unknown")
        self.fail(obj, f"datatype class {cls} ({what}) is not supported")

    def dataspace(self, d: bytes, obj: str):
        """The shape, () for a scalar, None for a null dataspace."""
        version, rank, flags = d[0], d[1], d[2]
        if version == 1:
            pos = 8
        elif version == 2:
            pos = 4
            if d[3] == 2:
                return None
        else:
            self.fail(obj, f"dataspace message version {version}")
        sl = self.sl
        return tuple(int.from_bytes(d[pos + i * sl:pos + (i + 1) * sl],
                                    "little") for i in range(rank))

    def element_size(self, dt: tuple) -> int:
        if dt[0] == "num":
            return dt[1].itemsize
        if dt[0] == "str":
            return dt[1]
        return 4 + self.so + 4

    def decode(self, raw: bytes, dt: tuple, shape, obj: str,
               as_text: bool = False):
        """Elements in `raw` as an array of `shape` (vlen strings as an
        object array of bytes, or of str where `as_text`)."""
        count = int(np.prod(shape, dtype=np.int64))
        if dt[0] == "num":
            return np.frombuffer(raw, dt[1], count).reshape(shape).copy()
        if dt[0] == "str":
            return np.frombuffer(raw, f"S{dt[1]}", count).reshape(shape) \
                .copy()
        so = self.so
        out = np.empty(count, object)
        step = 8 + so
        for i in range(count):
            e = raw[i * step:(i + 1) * step]
            n = int.from_bytes(e[:4], "little")
            coll = int.from_bytes(e[4:4 + so], "little")
            idx = int.from_bytes(e[4 + so:8 + so], "little")
            s = b"" if n == 0 else self.global_object(coll, idx, obj)[:n]
            out[i] = s.decode("utf-8" if dt[1] else "ascii") if as_text \
                else s
        return out.reshape(shape)

    def global_object(self, addr: int, idx: int, obj: str) -> bytes:
        if addr not in self.gcol:
            if self.bytes_at(addr, 4, obj, "global heap") != b"GCOL":
                self.fail(obj, "global heap collection without the GCOL "
                               "signature")
            size = self.u(addr + 8, self.sl)
            pos, end, objs = addr + 8 + self.sl, addr + size, {}
            while end - pos >= 8 + self.sl:
                i = self.u(pos, 2)
                n = self.u(pos + 8, self.sl)
                if i == 0:  # the free space ends the collection
                    break
                body = pos + 8 + self.sl
                objs[i] = self.bytes_at(body, n, obj, "global heap object")
                pos = body + _align8(n)
            self.gcol[addr] = objs
        objs = self.gcol[addr]
        if idx not in objs:
            self.fail(obj, f"global heap collection at {addr} has no "
                           f"object {idx}")
        return objs[idx]

    def attribute(self, d: bytes, obj: str):
        version = d[0]
        nsize, tsize, ssize = (int.from_bytes(d[i:i + 2], "little")
                               for i in (2, 4, 6))
        if version == 1:
            pad, pos = _align8, 8
        elif version in (2, 3):
            if d[1] & 0x03:
                self.fail(obj, "attribute with a shared datatype or "
                               "dataspace")
            pad, pos = (lambda n: n), (8 if version == 2 else 9)
        else:
            self.fail(obj, f"attribute message version {version}")
        name = bytes(d[pos:pos + nsize]).split(b"\0", 1)[0].decode("utf-8")
        pos += pad(nsize)
        try:
            dt = self.datatype(d[pos:pos + tsize], obj)
            pos += pad(tsize)
            shape = self.dataspace(d[pos:pos + ssize], obj)
        except ValueError as e:
            raise ValueError(f"{e} (attribute {name!r})") from None
        pos += pad(ssize)
        if shape is None:
            return name, None
        n = int(np.prod(shape, dtype=np.int64)) * self.element_size(dt)
        if pos + n > len(d):
            self.fail(obj, f"attribute {name!r} data runs past its message")
        value = self.decode(d[pos:pos + n], dt, shape, obj, as_text=True)
        return name, value[()] if shape == () else value

    def dataset(self, msgs: list, obj: str):
        dt = layout = fill = None
        shape = False
        for mtype, _, d in msgs:
            if mtype == _DATATYPE:
                dt = self.datatype(d, obj)
            elif mtype == _DATASPACE:
                shape = self.dataspace(d, obj)
            elif mtype == _LAYOUT:
                layout = d
            elif mtype == _FILL and fill is None:
                fill = self.fill_value(d)
            elif mtype == _EXTERNAL:
                self.fail(obj, "external data storage is not supported")
        if dt is None or shape is False:
            self.fail(obj, "dataset without a datatype or a dataspace")
        if shape is None:
            return None
        esize = self.element_size(dt)
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * esize
        version, cls = layout[0], layout[1]
        if version not in (3, 4):
            self.fail(obj, f"data layout message version {version}")
        if cls == 0:
            n = int.from_bytes(layout[2:4], "little")
            raw = bytes(layout[4:4 + n])
        elif cls == 1:
            addr = int.from_bytes(layout[2:2 + self.so], "little")
            if self.undefined(addr):
                if fill is not None and len(fill) != esize:
                    self.fail(obj, f"fill value of {len(fill)} bytes for "
                                   f"{esize}-byte elements")
                raw = (fill or bytes(esize)) * count
            else:
                raw = self.bytes_at(addr, nbytes, obj, "contiguous data")
        elif cls == 2:
            self.fail(obj, "chunked (or filtered) data layout, class 2, is "
                           "not supported")
        else:
            self.fail(obj, f"data layout class {cls} is not supported")
        if len(raw) < nbytes:
            self.fail(obj, f"compact data holds {len(raw)} of {nbytes} "
                           f"bytes")
        value = self.decode(raw[:nbytes], dt, shape, obj)
        return value[()] if shape == () else value

    @staticmethod
    def fill_value(d: bytes):
        version = d[0]
        if version in (1, 2):
            if version == 2 and not d[3]:
                return None
            n = int.from_bytes(d[4:8], "little")
            return bytes(d[8:8 + n]) if n else None
        if d[1] & 0x20:
            n = int.from_bytes(d[2:6], "little")
            return bytes(d[6:6 + n]) if n else None
        return None

    # the walk ----------------------------------------------------------------

    def walk(self):
        datasets: dict = {}
        attrs: dict = {}
        seen = set()

        def visit(addr: int, path: str):
            seen.add(addr)
            msgs = self.messages(addr, path)
            own = {}
            links = None
            for mtype, mflags, d in msgs:
                if mflags & 0x02 and mtype in (_DATASPACE, _DATATYPE,
                                                _FILL, _ATTRIBUTE):
                    self.fail(path, f"shared message of type {mtype:#x} is "
                                    f"not supported")
                if mtype == _ATTRIBUTE:
                    name, value = self.attribute(d, path)
                    own[name] = value
                elif mtype == _ATTR_INFO:
                    pos = 2 + (2 if d[1] & 0x01 else 0)
                    heap = int.from_bytes(d[pos:pos + self.so], "little")
                    if not self.undefined(heap):
                        self.fail(path, "dense attribute storage (a "
                                        "fractal heap) is not supported")
                elif mtype == _SYMBOL_TABLE:
                    links = (links or []) + self.symbol_table_links(d, path)
                elif mtype == _LINK_INFO:
                    pos = 2 + (8 if d[1] & 0x01 else 0)
                    heap = int.from_bytes(d[pos:pos + self.so], "little")
                    if not self.undefined(heap):
                        self.fail(path, "dense link storage (a fractal "
                                        "heap) is not supported")
                    links = links or []
                elif mtype == _LINK:
                    hard = self.link(d, path)
                    links = links or []
                    if hard is not None:
                        links.append(hard)
            attrs[path] = dict(sorted(own.items()))
            if links is not None:
                for name, child in sorted(links):
                    if child in seen:
                        continue
                    sub = name.decode("utf-8")
                    visit(child, f"{path}/{sub}" if path else sub)
            elif any(m[0] == _LAYOUT for m in msgs):
                datasets[path] = self.dataset(msgs, path)
            else:
                self.fail(path, "object is neither a group nor a dataset "
                                "(a committed datatype?)")

        visit(self.root, "")
        return datasets, attrs


def read_h5(path) -> tuple[dict, dict]:
    """-> (datasets, attrs) of the HDF5 file at `path`.

    `datasets` maps each dataset's full path ("model_weights/dense/dense/
    kernel:0") to its value: a numpy array in the file's dtype (a numpy
    scalar for a scalar dataspace, None for a null one; fixed-length
    strings as `S<n>`, variable-length strings as an object array of
    bytes). `attrs` maps every object's path ("" for the root) to a dict of
    its attributes, read as h5py reads them (variable-length strings as
    str). Both dicts follow h5py's `visititems` order: depth first, names
    in byte order within each group. Raises ValueError for what the codec
    does not read (see the module docstring)."""
    return _Reader(path).walk()


# -- writing ------------------------------------------------------------------

class _Writer:
    """Appends structures to one buffer; addresses are byte offsets in it."""

    def __init__(self):
        self.buf = bytearray(96)  # the superblock, written last

    def put(self, data: bytes) -> int:
        addr = len(self.buf)
        self.buf += data
        self.buf += bytes(_align8(len(data)) - len(data))
        return addr

    @staticmethod
    def message(mtype: int, data: bytes, flags: int = 0) -> bytes:
        data += bytes(_align8(len(data)) - len(data))
        return struct.pack("<HHB3x", mtype, len(data), flags) + data

    def object_header(self, messages: list) -> int:
        body = b"".join(messages)
        return self.put(struct.pack("<BxHII4x", 1, len(messages), 1,
                                    len(body)) + body)

    @staticmethod
    def datatype(dtype: np.dtype) -> bytes:
        if dtype.kind == "f":
            sign, eloc, esize, mloc, msize, bias = {
                2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
                8: (63, 52, 11, 0, 52, 1023)}[dtype.itemsize]
            return struct.pack("<B3BI", 0x11, 0x20, sign, 0,
                               dtype.itemsize) + struct.pack(
                "<HHBBBBI", 0, 8 * dtype.itemsize, eloc, esize, mloc, msize,
                bias)
        if dtype.kind in "iu":
            return struct.pack("<B3BI", 0x10, 0x08 if dtype.kind == "i"
                               else 0, 0, 0, dtype.itemsize) + struct.pack(
                "<HH", 0, 8 * dtype.itemsize)
        if dtype.kind == "S":  # null-padded ASCII, h5py's fixed strings
            return struct.pack("<B3BI", 0x13, 0x01, 0, 0, dtype.itemsize)
        raise ValueError(f"write_h5 writes numeric and fixed-length byte "
                         f"string data, not {dtype}")

    @staticmethod
    def dataspace(shape: tuple) -> bytes:
        return struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
            struct.pack("<Q", n) for n in shape)

    @staticmethod
    def _array(value) -> np.ndarray:
        a = np.asarray(value)
        if a.dtype.kind in "fiu":
            a = a.astype(a.dtype.newbyteorder("<"))
        return a  # tobytes() writes C order whatever the strides

    def attributes(self, attrs: dict) -> list:
        out = []
        for name, value in attrs.items():
            a = self._array(value)
            nm = name.encode("utf-8") + b"\0"
            dt, ds = self.datatype(a.dtype), self.dataspace(a.shape)
            body = struct.pack("<BxHHH", 1, len(nm), len(dt), len(ds))
            for part in (nm, dt, ds):
                body += part + bytes(_align8(len(part)) - len(part))
            out.append(self.message(_ATTRIBUTE, body + a.tobytes()))
        return out

    def dataset(self, value, attrs: dict) -> int:
        a = self._array(value)
        addr = self.put(a.tobytes()) if a.nbytes else (1 << 64) - 1
        fill = struct.pack("<BBBB", 2, 2, 2, 1) + struct.pack("<I", 0)
        layout = struct.pack("<BBQQ", 3, 1, addr, a.nbytes)
        return self.object_header(
            [self.message(_DATASPACE, self.dataspace(a.shape)),
             self.message(_DATATYPE, self.datatype(a.dtype), flags=0x01),
             self.message(_FILL, fill, flags=0x01),
             self.message(_LAYOUT, layout)] + self.attributes(attrs))

    def group(self, entries: list, attrs: dict) -> tuple[int, int, int]:
        """An old-style group over `entries` [(name bytes, address,
        (btree, heap) or None)]: -> (object header, B-tree, heap)."""
        entries = sorted(entries)
        heap_data = bytearray(8)  # offset 0: the empty string
        offsets = []
        for name, _, _ in entries:
            offsets.append(len(heap_data))
            heap_data += name + b"\0"
            heap_data += bytes(_align8(len(heap_data)) - len(heap_data))
        heap = self.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data),
                                              1, len(self.buf) + 32)
                        + bytes(heap_data))
        cap = 2 * _LEAF_K
        leaves = []  # (address, largest name's heap offset)
        for i in range(0, len(entries), cap):
            part = entries[i:i + cap]
            node = bytearray(b"SNOD" + struct.pack("<BxH", 1, len(part)))
            for (name, addr, cache), off in zip(part, offsets[i:i + cap]):
                node += struct.pack("<QQ", off, addr)
                if cache is None:
                    node += struct.pack("<II16x", 0, 0)
                else:
                    node += struct.pack("<IIQQ", 1, 0, *cache)
            node += bytes(8 + cap * 40 - len(node))
            leaves.append((self.put(bytes(node)), offsets[i + len(part) - 1]))
        btree = self._btree(leaves, 0)
        stab = self.message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))
        return self.object_header([stab] + self.attributes(attrs)), btree, \
            heap

    def _btree(self, children: list, level: int) -> int:
        """Group B-tree nodes of `level` over `children` [(address, key)],
        up to the root; -> the root's address."""
        cap = 2 * _INTERNAL_K
        size = 8 + 2 * 8 + (2 * _INTERNAL_K + 1) * 8 + cap * 8
        groups = [children[i:i + cap]
                  for i in range(0, len(children), cap)] or [[]]
        base = len(self.buf)
        addrs = [base + i * size for i in range(len(groups))]
        undef = (1 << 64) - 1
        parents = []
        for i, part in enumerate(groups):
            node = bytearray(b"TREE" + struct.pack(
                "<BBH", 0, level, len(part)))
            node += struct.pack("<QQ", addrs[i - 1] if i else undef,
                                addrs[i + 1] if i + 1 < len(groups)
                                else undef)
            node += struct.pack("<Q", 0)
            for child, key in part:
                node += struct.pack("<QQ", child, key)
            node += bytes(size - len(node))
            self.put(bytes(node))
            parents.append((addrs[i], part[-1][1] if part else 0))
        if len(parents) == 1:
            return parents[0][0]
        return self._btree(parents, level + 1)

    def superblock(self, root: int, btree: int, heap: int) -> None:
        eof = len(self.buf)
        sb = _SIGNATURE + struct.pack(
            "<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _INTERNAL_K, 0)
        sb += struct.pack("<QQQQ", 0, (1 << 64) - 1, eof, (1 << 64) - 1)
        sb += struct.pack("<QQIIQQ", 0, root, 1, 0, btree, heap)
        self.buf[:96] = sb


def _tree(datasets: dict) -> dict:
    """Nested dicts of group name -> subtree, dataset name -> path."""
    root: dict = {}
    for path in datasets:
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"write_h5: {path!r} lies under a dataset")
        if parts[-1] in node:
            raise ValueError(f"write_h5: {path!r} is written twice")
        node[parts[-1]] = path
    return root


def write_h5(path, datasets: dict, attrs: dict | None = None) -> None:
    """Write `datasets` {full path: array} and `attrs` {object path ("" for
    the root): {name: value}} as an HDF5 file of the layout h5py writes at
    its defaults (see the module docstring). Groups are made from the
    paths; an attribute on a path that is neither raises. Values: numeric
    arrays (stored little-endian) or fixed-length byte strings (`S<n>`
    arrays and `np.bytes_` scalars, null-padded ASCII). The file is written
    under a temporary name and moved into place in one step."""
    attrs = dict(attrs or {})
    w = _Writer()

    def emit(node: dict, prefix: str) -> tuple[int, int, int]:
        entries = []
        for name, sub in node.items():
            full = f"{prefix}/{name}" if prefix else name
            if isinstance(sub, dict):
                oh, bt, hp = emit(sub, full)
                entries.append((name.encode("utf-8"), oh, (bt, hp)))
            else:
                entries.append((name.encode("utf-8"),
                                w.dataset(datasets[sub],
                                          attrs.pop(full, {})), None))
        return w.group(entries, attrs.pop(prefix, {}))

    root, btree, heap = emit(_tree(datasets), "")
    if attrs:
        raise ValueError(f"write_h5: attributes on objects that are not in "
                         f"the file: {sorted(attrs)}")
    w.superblock(root, btree, heap)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(w.buf)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
