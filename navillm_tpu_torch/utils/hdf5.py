"""HDF5 feature files read and written in plain Python and numpy, without
h5py.

The card's machine has no h5py, and every config names its view features
as HDF5 files (``Feature.feature_database``). This module reads and writes
the layout h5py gives under its default file settings (libver
'earliest'), which is what the extractors write and the feature stores
read, through the subset of h5py's interface that both call:

  ``File(path, "r")``: ``keys()``, ``in``, ``f[key]`` (a path with ``/``
  walks nested groups), ``close()`` and ``with``; a dataset has
  ``.shape``, ``.dtype``, ``.chunks`` and ``np.asarray(d)`` / ``d[...]``.
  ``File(path, "w")``: ``create_dataset(key, data=..., compression=
  "gzip")`` and ``f[key] = arr``.

What is read (HDF5 file format specification, version 0 structures):
  - superblock v0 and v1 (at the start of the file: no user block);
  - version-1 object headers, with continuation blocks;
  - symbol-table groups: v1 B-trees of any depth, ``SNOD`` symbol nodes
    and local heaps; nested groups;
  - dataspace v1 (scalar and simple);
  - datatypes: fixed-point (1, 2, 4, 8 bytes) and IEEE floats (f16, f32,
    f64), either byte order;
  - fill-value messages, old and new;
  - layout v3: compact, contiguous, and chunked with a v1 B-tree chunk
    index; edge chunks are cropped to the shape;
  - filter pipeline v1 with deflate (1), shuffle (2) and fletcher32 (3,
    its checksum verified), honouring each chunk's filter mask;
  - attribute, comment and modification-time messages are skipped
    without being decoded.
Anything else (superblock v2/v3, v2 object headers, link messages,
fractal heaps, v2 B-tree or extensible-array chunk indices, other
filters, string or compound datatypes, ...) raises ValueError naming the
structure and the file. Nothing falls back.

A reader holds one file descriptor and reads through ``os.pread``: there
is no shared file position, so the feature
prefetcher's worker threads (data/prefetch.py) read at once. A group's
name-to-header map is built once, when the group is first opened (the
root's at open).

What is written: superblock v0, a symbol-table root group (local heap,
``SNOD`` nodes of 8 entries and a group B-tree of as many levels as the
key count needs, built at ``close()``), version-1 object headers, and per
dataset either a contiguous layout or, with ``compression="gzip"``, a
chunked one with h5py's chunk shape (``guess_chunk``), deflate at h5py's
default level 4 and a v1 B-tree chunk index. Datasets are written as they come, so a file larger
than memory is never held in it.
"""
from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x0, 0x1, 0x2, 0x3
_FILL_OLD, _FILL, _LINK, _EXTERNAL, _LAYOUT = 0x4, 0x5, 0x6, 0x7, 0x8
_GROUP_INFO, _PIPELINE, _ATTRIBUTE = 0xA, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
# messages that describe the object without changing its data: skipped
_SKIPPED = {_NIL, 0x9, _ATTRIBUTE, 0xD, 0xE, 0x12, 0x15, 0x16}
_DATASET_MESSAGES = {_DATASPACE, _DATATYPE, _FILL_OLD, _FILL, _LAYOUT,
                     _PIPELINE}
_MESSAGE_NAMES = {
    _LINK_INFO: "link info message (a new-style group)",
    _LINK: "link message (a new-style group)",
    _GROUP_INFO: "group info message (a new-style group)",
    _EXTERNAL: "external data files message",
    0xF: "shared message table",
    0x13: "B-tree 'K' values message",
    0x14: "driver info message",
    0x17: "file space info message",
}

_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset", 307: "bzip2",
                 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32008: "bitshuffle", 32015: "zstd"}
_DATATYPE_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                     6: "compound", 7: "reference", 8: "enum",
                     9: "variable-length", 10: "array"}
# IEEE layouts: size -> (exponent location, exponent size, mantissa
# location, mantissa size, exponent bias)
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127),
         8: (52, 11, 0, 52, 1023)}

# h5py's defaults: gzip level, and guess_chunk's sizes (h5py/_hl/filters.py)
DEFAULT_GZIP = 4
_CHUNK_BASE, _CHUNK_MIN, _CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024
# HDF5's defaults for libver 'earliest': group leaf node K, group internal
# node K, chunk index node K
_LEAF_K, _GROUP_K, _CHUNK_K = 4, 16, 32


def _uint(buf, pos: int, n: int) -> int:
    return int.from_bytes(buf[pos: pos + n], "little")


def _undefined(value: int, n: int) -> bool:
    return value == (1 << (8 * n)) - 1


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit
    words, both sums folded to 17 bits every 360 words."""
    n = len(data) // 2
    words = np.frombuffer(data[: 2 * n], ">u2").astype(np.int64)
    s1 = s2 = 0
    for k in range(0, n, 360):
        w = words[k: k + 360]
        t = len(w)
        # sum1 += w_j then sum2 += sum1, for j = 1..t
        s2 += t * s1 + int(np.dot(np.arange(t, 0, -1, dtype=np.int64), w))
        s1 += int(w.sum())
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return ((s2 << 16) | s1) & 0xFFFFFFFF


def _unshuffle(buf: bytes, size: int) -> bytes:
    n = len(buf) // size
    if size <= 1 or n <= 1:
        return buf
    body = np.frombuffer(buf, np.uint8, n * size).reshape(size, n)
    return body.T.tobytes() + buf[n * size:]


def guess_chunk(shape: Sequence[int], typesize: int) -> Tuple[int, ...]:
    """h5py's chunk shape for a dataset of ``shape`` (h5py's guess_chunk):
    halve the axes in turn, first to last, until the chunk is under the
    target size (a PyTables rule, 8 KiB to 1 MiB) or within half of it."""
    shape = tuple(x if x != 0 else 1024 for x in shape)
    if not shape:
        raise ValueError("chunks are not allowed for scalar datasets")
    chunks = np.array(shape, dtype="=f8")
    dset_size = np.prod(chunks) * typesize
    target = _CHUNK_BASE * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target = min(max(target, _CHUNK_MIN), _CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = np.prod(chunks) * typesize
        if (chunk_bytes < target or abs(chunk_bytes - target) / target < 0.5) \
                and chunk_bytes < _CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = np.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


# ----------------------------------------------------------------- reader


class _Message:
    __slots__ = ("type", "flags", "data")

    def __init__(self, type_: int, flags: int, data: memoryview):
        self.type, self.flags, self.data = type_, flags, data


class Group:
    """A symbol-table group: name -> object, read-only."""

    def __init__(self, file: "FileReader", name: str,
                 links: Dict[str, Tuple[int, int]]):
        self.file, self.name = file, name
        self._links = links          # name -> (header address, cache type)

    def keys(self) -> List[str]:
        return list(self._links)

    def __len__(self) -> int:
        return len(self._links)

    def __contains__(self, path) -> bool:
        try:
            self._walk(path)
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        return self._walk(path)

    def _walk(self, path: str):
        node = self.file if path.startswith("/") else self
        parts = [p for p in path.split("/") if p]
        if not parts:
            return node
        for part in parts:
            if not isinstance(node, Group):
                raise KeyError(f"{node.name} is a dataset, not a group")
            if part not in node._links:
                raise KeyError(f"{part!r} is not in group {node.name!r} of "
                               f"{self.file.filename}")
            addr, cache = node._links[part]
            name = node.name.rstrip("/") + "/" + part
            if cache == 2:
                raise ValueError(f"{self.file.filename}: {name} is a soft "
                                 f"link, which is not read")
            node = self.file._open_object(addr, name)
        return node


class Dataset:
    """One dataset: its shape, type and layout are read at open, its data
    on every ``read()``."""

    def __init__(self, file: "FileReader", name: str,
                 messages: List[_Message]):
        self.file, self.name = file, name
        where = f"{file.filename}: dataset {name}"
        by_type = {}
        for m in messages:
            by_type.setdefault(m.type, m)
        for t in (_DATASPACE, _DATATYPE, _LAYOUT):
            if t not in by_type:
                raise ValueError(f"{where}: no message of type {t:#x}")
        self.shape = _dataspace(by_type[_DATASPACE].data, where)
        self.dtype = _datatype(by_type[_DATATYPE].data, where)
        self._fill = _fill_value(by_type.get(_FILL), by_type.get(_FILL_OLD),
                                 self.dtype, where)
        self._filters = (_pipeline(by_type[_PIPELINE].data, where)
                         if _PIPELINE in by_type else [])
        self._layout = _layout(by_type[_LAYOUT].data, file, where)
        self.chunks = self._layout[1] if self._layout[0] == 2 else None
        self.compression = ("gzip" if any(f[0] == _DEFLATE
                                          for f in self._filters) else None)
        self.compression_opts = next(
            (f[2][0] if f[2] else None
             for f in self._filters if f[0] == _DEFLATE), None)
        self.shuffle = any(f[0] == _SHUFFLE for f in self._filters)
        self.fletcher32 = any(f[0] == _FLETCHER32 for f in self._filters)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def __repr__(self):
        return (f"<HDF5 dataset {self.name!r}: shape {self.shape}, "
                f"type {self.dtype.str!r}>")

    def __array__(self, dtype=None, copy=None):
        a = self.read()
        return a if dtype is None else a.astype(dtype, copy=False)

    def __getitem__(self, key):
        a = self.read()
        return a if key is Ellipsis else a[key]

    def read(self) -> np.ndarray:
        kind = self._layout[0]
        if kind == 0:                           # compact: in the header
            raw = self._layout[1]
            n = self.size * self.dtype.itemsize
            if len(raw) < n:
                raise ValueError(f"{self.file.filename}: dataset "
                                 f"{self.name}: compact data holds "
                                 f"{len(raw)} of {n} bytes")
            return np.frombuffer(raw, self.dtype, self.size) \
                .reshape(self.shape).copy()
        if kind == 1:                           # contiguous
            addr = self._layout[1]
            if addr is None:
                return np.full(self.shape, self._fill, self.dtype)
            raw = self.file._pread(addr, self.size * self.dtype.itemsize)
            return np.frombuffer(raw, self.dtype).reshape(self.shape).copy()
        return self._read_chunked(np.empty(self.shape, self.dtype))

    def _read_chunked(self, out: np.ndarray) -> np.ndarray:
        _, cshape, btree = self._layout
        if btree is None:
            out[...] = self._fill
            return out
        rank = len(self.shape)
        chunks = self.file._chunk_index(btree, rank, self.name)
        grid = math.prod(-(-s // c) for s, c in zip(self.shape, cshape))
        if len(chunks) < grid:
            out[...] = self._fill
        n = math.prod(cshape) * self.dtype.itemsize
        for offset, size, mask, addr in chunks:
            buf = self._unfilter(self.file._pread(addr, size), mask, addr)
            if len(buf) != n:
                raise ValueError(f"{self.file.filename}: dataset "
                                 f"{self.name}: chunk at {addr} holds "
                                 f"{len(buf)} bytes, not {n}")
            block = np.frombuffer(buf, self.dtype).reshape(cshape)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offset, cshape, self.shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _unfilter(self, buf: bytes, mask: int, addr: int) -> bytes:
        for k in range(len(self._filters) - 1, -1, -1):
            if mask & (1 << k):
                continue
            fid, _, values = self._filters[k]
            if fid == _DEFLATE:
                buf = zlib.decompress(buf)
            elif fid == _SHUFFLE:
                buf = _unshuffle(buf, values[0] if values
                                 else self.dtype.itemsize)
            else:                               # fletcher32
                body, stored = buf[:-4], _uint(buf, len(buf) - 4, 4)
                sum_ = fletcher32(body)
                # HDF5 also accepts the checksum of its releases before
                # 1.6.3, with the bytes of each 16-bit half swapped
                swapped = (((sum_ & 0x00FF00FF) << 8)
                           | ((sum_ >> 8) & 0x00FF00FF))
                if stored not in (sum_, swapped):
                    raise ValueError(
                        f"{self.file.filename}: dataset {self.name}: "
                        f"fletcher32 checksum of the chunk at {addr} does "
                        f"not match ({stored:#010x} stored, {sum_:#010x} "
                        f"computed)")
                buf = body
        return buf


def _dataspace(d: memoryview, where: str) -> Tuple[int, ...]:
    version, rank = d[0], d[1]
    if version != 1:
        raise ValueError(f"{where}: dataspace v{version} is not read "
                         f"(v1 only)")
    return tuple(_uint(d, 8 + 8 * i, 8) for i in range(rank))


def _datatype(d: memoryview, where: str) -> np.dtype:
    cls, version = d[0] & 0x0F, d[0] >> 4
    bits = d[1] | (d[2] << 8) | (d[3] << 16)
    size = _uint(d, 4, 4)
    if cls not in (0, 1):
        raise ValueError(f"{where}: datatype class "
                         f"{_DATATYPE_CLASSES.get(cls, cls)} is not read "
                         f"(integers and IEEE floats only)")
    if version != 1:
        raise ValueError(f"{where}: datatype message v{version} is not "
                         f"read")
    if cls == 1 and bits & 0x40:
        raise ValueError(f"{where}: a VAX-order float is not read")
    order = ">" if bits & 1 else "<"
    offset, precision = _uint(d, 8, 2), _uint(d, 10, 2)
    if offset != 0 or precision != 8 * size:
        raise ValueError(f"{where}: a type with {precision} bits at offset "
                         f"{offset} of {size} bytes is not read")
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise ValueError(f"{where}: a {size}-byte integer is not read")
        return np.dtype(f"{order}{'i' if bits & 0x8 else 'u'}{size}")
    fields = (d[12], d[13], d[14], d[15], _uint(d, 16, 4))
    if _IEEE.get(size) != fields:
        raise ValueError(f"{where}: a {size}-byte float with fields "
                         f"{fields} is not IEEE 754")
    return np.dtype(f"{order}f{size}")


def _fill_value(new: Optional[_Message], old: Optional[_Message],
                dtype: np.dtype, where: str):
    raw = b""
    if new is not None:
        d = new.data
        version = d[0]
        if version in (1, 2):
            if version == 1 or d[3]:
                raw = bytes(d[8: 8 + _uint(d, 4, 4)])
        elif version == 3:
            if d[1] & 0x20:
                raw = bytes(d[6: 6 + _uint(d, 2, 4)])
        else:
            raise ValueError(f"{where}: fill value message v{version} is "
                             f"not read")
    elif old is not None:
        raw = bytes(old.data[4: 4 + _uint(old.data, 0, 4)])
    if len(raw) != dtype.itemsize:
        return np.zeros((), dtype)
    return np.frombuffer(raw, dtype)[0]


def _pipeline(d: memoryview, where: str):
    """[(filter id, flags, client values)], in pipeline order."""
    version, n = d[0], d[1]
    if version != 1:
        raise ValueError(f"{where}: filter pipeline v{version} is not read "
                         f"(v1 only)")
    out, p = [], 8
    for _ in range(n):
        fid, name_len, flags, nvals = struct.unpack_from("<4H", d, p)
        p += 8
        name = bytes(d[p: p + name_len]).split(b"\0")[0].decode(
            "ascii", "replace")
        p += name_len
        values = list(struct.unpack_from(f"<{nvals}I", d, p))
        p += 4 * nvals + (4 if nvals % 2 else 0)
        if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
            label = _FILTER_NAMES.get(fid, name or "unregistered")
            raise ValueError(f"{where}: filter {fid} ({label}) is not read "
                             f"(deflate, shuffle and fletcher32 only)")
        out.append((fid, flags, values))
    return out


def _layout(d: memoryview, file: "FileReader", where: str):
    """(0, raw bytes) compact, (1, address or None, size) contiguous,
    (2, chunk shape, B-tree address or None) chunked."""
    version, kind = d[0], d[1]
    if version != 3:
        label = ("HDF5 1.10 chunk indices" if version == 4
                 else "HDF5 1.4 and older")
        raise ValueError(f"{where}: data layout message v{version} "
                         f"({label}) is not read (v3 only)")
    so = file._so
    if kind == 0:
        n = _uint(d, 2, 2)
        return (0, bytes(d[4: 4 + n]))
    if kind == 1:
        addr = _uint(d, 2, so)
        return (1, None if _undefined(addr, so) else addr + file._base,
                _uint(d, 2 + so, file._sl))
    if kind == 2:
        ndims = d[2]
        addr = _uint(d, 3, so)
        dims = tuple(_uint(d, 3 + so + 4 * i, 4) for i in range(ndims))
        return (2, dims[:-1],
                None if _undefined(addr, so) else addr + file._base)
    raise ValueError(f"{where}: data layout class {kind} is not read")


class FileReader(Group):
    """An HDF5 file opened for reading (``File(path, "r")``)."""

    def __init__(self, path):
        self.filename = os.fspath(path)
        self._fd = None
        self._fd = os.open(self.filename, os.O_RDONLY)
        try:
            self._read_superblock()
            super().__init__(self, "/", self._links_of(self._root, "/"))
        except BaseException:
            self.close()
            raise

    # ---- raw reads (no shared file position)

    def _pread(self, addr: int, n: int) -> bytes:
        buf = os.pread(self._fd, n, addr)
        if len(buf) != n:
            raise ValueError(f"{self.filename}: {n} bytes at {addr} run "
                             f"past the end of the file (truncated?)")
        return buf

    # ---- structures

    def _read_superblock(self):
        head = os.pread(self._fd, 24, 0)
        if head[:8] != SIGNATURE or len(head) < 24:
            raise ValueError(f"{self.filename}: not an HDF5 file (no "
                             f"superblock signature at 0; user blocks are "
                             f"not read)")
        version = head[8]
        if version not in (0, 1):
            raise ValueError(f"{self.filename}: superblock v{version} is "
                             f"not read (v0 and v1 only, as h5py writes "
                             f"under libver 'earliest')")
        so, sl = head[13], head[14]
        if so not in (2, 4, 8) or sl not in (2, 4, 8):
            raise ValueError(f"{self.filename}: {so}-byte offsets and "
                             f"{sl}-byte lengths are not read")
        self._so, self._sl = so, sl
        self._leaf_k = _uint(head, 16, 2)
        p = 24 + (4 if version == 1 else 0)
        buf = self._pread(0, p + 4 * so + 2 * so + 24)
        self._base = _uint(buf, p, so)
        # the root group's symbol table entry follows the four addresses
        entry = p + 4 * so
        self._root = _uint(buf, entry + so, so) + self._base

    def _header(self, addr: int, where: str) -> List[_Message]:
        """The messages of the version-1 object header at ``addr``,
        continuation blocks followed."""
        head = self._pread(addr, 16)
        if head[:4] == b"OHDR":
            raise ValueError(f"{self.filename}: {where}: v2 object header "
                             f"is not read (v1 only)")
        if head[0] != 1:
            raise ValueError(f"{self.filename}: {where}: object header "
                             f"v{head[0]} at {addr} is not read")
        blocks = [(addr + 16, _uint(head, 8, 4))]
        out: List[_Message] = []
        while blocks:
            start, n = blocks.pop(0)
            buf = memoryview(self._pread(start, n))
            p = 0
            while p + 8 <= n:
                mtype, msize, flags = _uint(buf, p, 2), _uint(buf, p + 2, 2), \
                    buf[p + 4]
                data = buf[p + 8: p + 8 + msize]
                p += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append((_uint(data, 0, self._so) + self._base,
                                   _uint(data, self._so, self._sl)))
                    continue
                if mtype in _SKIPPED:
                    continue
                if flags & 0x2:
                    raise ValueError(f"{self.filename}: {where}: shared "
                                     f"message of type {mtype:#x} is not "
                                     f"read")
                out.append(_Message(mtype, flags, data))
        return out

    def _open_object(self, addr: int, name: str):
        messages = self._header(addr, name)
        types = {m.type for m in messages}
        if _SYMBOL_TABLE in types:
            return Group(self, name, self._links_of(addr, name, messages))
        if _LINK_INFO in types or _LINK in types:
            self._new_style(messages, name)
        for t in sorted(types - _DATASET_MESSAGES):
            raise ValueError(f"{self.filename}: {name}: "
                             f"{_MESSAGE_NAMES.get(t, f'message {t:#x}')} "
                             f"is not read")
        if _LAYOUT not in types:
            raise ValueError(f"{self.filename}: {name} is neither a group "
                             f"nor a dataset (no symbol table or layout "
                             f"message)")
        return Dataset(self, name, messages)

    def _new_style(self, messages, name):
        for m in messages:
            if m.type == _LINK_INFO:
                flags = m.data[1]
                heap = _uint(m.data, 2 + (8 if flags & 1 else 0), self._so)
                if not _undefined(heap, self._so):
                    raise ValueError(f"{self.filename}: {name}: fractal "
                                     f"heap of a dense new-style group is "
                                     f"not read")
        raise ValueError(f"{self.filename}: {name}: link messages (a "
                         f"new-style group) are not read")

    def _links_of(self, addr: int, name: str, messages=None
                  ) -> Dict[str, Tuple[int, int]]:
        if messages is None:
            messages = self._header(addr, name)
        stab = next((m for m in messages if m.type == _SYMBOL_TABLE), None)
        if stab is None:
            return self._new_style(messages, name)
        so = self._so
        btree = _uint(stab.data, 0, so) + self._base
        heap = self._heap(_uint(stab.data, so, so) + self._base, name)
        links: Dict[str, Tuple[int, int]] = {}
        entry = 2 * so + 24
        for node in self._btree_leaves(btree, 0, name):
            buf = self._pread(node, 8 + 2 * self._leaf_k * entry)
            if buf[:4] != b"SNOD":
                raise ValueError(f"{self.filename}: {name}: no symbol table "
                                 f"node at {node}")
            for k in range(_uint(buf, 6, 2)):
                p = 8 + k * entry
                off = _uint(buf, p, so)
                end = heap.index(b"\0", off)
                key = heap[off:end].decode("utf-8")
                links[key] = (_uint(buf, p + so, so) + self._base,
                              _uint(buf, p + 2 * so, 4))
        return links

    def _heap(self, addr: int, name: str) -> bytes:
        sl, so = self._sl, self._so
        head = self._pread(addr, 8 + 2 * sl + so)
        if head[:4] != b"HEAP":
            raise ValueError(f"{self.filename}: {name}: no local heap at "
                             f"{addr}")
        size = _uint(head, 8, sl)
        return self._pread(_uint(head, 8 + 2 * sl, so) + self._base, size)

    def _btree_node(self, addr: int, node_type: int, key_size: int,
                    where: str):
        """(level, [left key bytes], [child address]) of a v1 B-tree
        node."""
        so = self._so
        head = self._pread(addr, 8 + 2 * so)
        if head[:4] != b"TREE":
            raise ValueError(f"{self.filename}: {where}: no v1 B-tree node "
                             f"at {addr} (a v2 B-tree or another index is "
                             f"not read)")
        if head[4] != node_type:
            raise ValueError(f"{self.filename}: {where}: B-tree node type "
                             f"{head[4]} at {addr}, expected {node_type}")
        level, n = head[5], _uint(head, 6, 2)
        body = self._pread(addr + 8 + 2 * so, n * (key_size + so) + key_size)
        keys = [body[k * (key_size + so): k * (key_size + so) + key_size]
                for k in range(n)]
        children = [_uint(body, k * (key_size + so) + key_size, so)
                    + self._base for k in range(n)]
        return level, keys, children

    def _btree_leaves(self, addr: int, node_type: int, where: str,
                      key_size: Optional[int] = None):
        """The children of the level-0 nodes, in key order, with their
        keys."""
        key_size = self._sl if key_size is None else key_size
        out = []
        stack = [addr]
        while stack:
            level, keys, children = self._btree_node(stack.pop(), node_type,
                                                     key_size, where)
            if level == 0:
                out.extend(children if node_type == 0
                           else list(zip(keys, children)))
            else:
                stack.extend(reversed(children))
        return out

    def _chunk_index(self, addr: int, rank: int, name: str):
        """[(offset, stored size, filter mask, address)] of every chunk."""
        key_size = 8 + 8 * (rank + 1)
        out = []
        for key, child in self._btree_leaves(addr, 1, name, key_size):
            size, mask = _uint(key, 0, 4), _uint(key, 4, 4)
            offset = tuple(_uint(key, 8 + 8 * i, 8) for i in range(rank))
            out.append((offset, size, mask, child))
        return out

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass



# ----------------------------------------------------------------- writer

_UNDEF = (1 << 64) - 1
_SUPERBLOCK_SIZE = 96
_ENTRY_SIZE = 40            # a symbol table entry with 8-byte offsets


def _message(mtype: int, flags: int, data: bytes) -> bytes:
    data += bytes(-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: Sequence[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _dataspace_message(shape: Tuple[int, ...]) -> bytes:
    """Dataspace v1, the maximum dimensions equal to the dimensions (as
    h5py writes a dataset without ``maxshape``)."""
    flags = 1 if shape else 0
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBB5x", 1, len(shape), flags) + dims \
        + (dims if shape else b"")


def _datatype_message(dtype: np.dtype, where: str) -> bytes:
    size = dtype.itemsize
    big = dtype.byteorder == ">" or (dtype.byteorder == "="
                                     and np.little_endian is False)
    if dtype.kind == "f" and size in _IEEE:
        exp_loc, exp_size, man_loc, man_size, bias = _IEEE[size]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20 | big, 8 * size - 1,
                           0, size, 0, 8 * size, exp_loc, exp_size, man_loc,
                           man_size, bias)
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        return struct.pack("<BBBBIHH", 0x10,
                           big | (0x8 if dtype.kind == "i" else 0), 0, 0,
                           size, 0, 8 * size)
    raise ValueError(f"{where}: a dataset of type {dtype} is not written "
                     f"(integers and IEEE floats only)")


class FileWriter:
    """An HDF5 file opened for writing (``File(path, "w")``). Each dataset
    goes to disk when it is created; the root group (heap, symbol nodes,
    B-tree, header) and the superblock are written at ``close()``."""

    def __init__(self, path):
        self.filename = os.fspath(path)
        self._f = None
        self._f = open(self.filename, "wb")
        self._f.write(bytes(_SUPERBLOCK_SIZE))
        self._pos = _SUPERBLOCK_SIZE
        self._links: Dict[bytes, int] = {}

    def _align(self) -> int:
        """Pad the file to an 8-byte boundary; returns the position."""
        pad = -self._pos % 8
        if pad:
            self._f.write(bytes(pad))
            self._pos += pad
        return self._pos

    def _write(self, data: bytes, align: bool = True) -> int:
        addr = self._align() if align else self._pos
        self._f.write(data)
        self._pos += len(data)
        return addr

    def __setitem__(self, name: str, data):
        self.create_dataset(name, data=data)

    def create_dataset(self, name: str, data,
                       compression: Optional[str] = None):
        """Write ``data`` under ``name`` as h5py's ``create_dataset`` of
        the same arguments lays it out: contiguous, or with
        ``compression="gzip"`` chunked in h5py's chunk shape for it and
        deflated at h5py's default level (4)."""
        where = f"{self.filename}: dataset {name}"
        if self._f is None:
            raise ValueError(f"{where}: the file is closed")
        key = name.encode("utf-8")
        if not key or b"/" in key or b"\0" in key:
            raise ValueError(f"{where}: only a plain name in the root group "
                             f"is written (no '/', not empty)")
        if key in self._links:
            raise ValueError(f"{where}: the name already exists")
        if compression not in (None, "gzip"):
            raise ValueError(f"{where}: compression {compression!r} is not "
                             f"written (gzip only)")
        arr = np.asarray(data)
        dtype_msg = _datatype_message(arr.dtype, where)
        if compression is not None:
            if not arr.shape:
                raise ValueError(f"{where}: a scalar dataset is not chunked")
            chunks = guess_chunk(arr.shape, arr.dtype.itemsize)
            btree = self._write_chunks(arr, chunks)
            layout = struct.pack(f"<BBBQ{arr.ndim + 1}I", 3, 2, arr.ndim + 1,
                                 btree, *chunks, arr.dtype.itemsize)
            alloc = 3                           # incremental
        else:
            raw = np.ascontiguousarray(arr).tobytes()
            addr = self._write(raw, align=False) if raw else _UNDEF
            layout = struct.pack("<BBQQ", 3, 1, addr, len(raw))
            alloc = 2                           # late
        messages = [
            _message(_DATASPACE, 0, _dataspace_message(arr.shape)),
            _message(_DATATYPE, 1, dtype_msg),
            # fill value v2: allocation time, fill when set, the default
            # (zero) value
            _message(_FILL, 1, struct.pack("<BBBBI", 2, alloc, 2, 1, 0))]
        if compression is not None:
            name_ = b"deflate\0"
            messages.append(_message(_PIPELINE, 1, struct.pack(
                "<BB6xHHHH", 1, 1, _DEFLATE, len(name_), 1, 1) + name_
                + struct.pack("<I4x", DEFAULT_GZIP)))
        messages.append(_message(_LAYOUT, 0, layout))
        self._links[key] = self._write(_object_header(messages))

    def _write_chunks(self, arr: np.ndarray, chunks: Tuple[int, ...]) -> int:
        """Every chunk of ``arr`` in C order (edge chunks padded with
        zeros to the chunk shape, as HDF5 stores them), deflated, then
        their v1 B-tree; returns the tree's address (undefined with no
        chunk)."""
        grid = [-(-s // c) for s, c in zip(arr.shape, chunks)]
        entries = []
        last = None
        for idx in np.ndindex(*grid):
            offset = tuple(i * c for i, c in zip(idx, chunks))
            src = tuple(slice(o, o + c) for o, c in zip(offset, chunks))
            block = arr[src]
            if block.shape != chunks:
                full = np.zeros(chunks, arr.dtype)
                full[tuple(slice(0, n) for n in block.shape)] = block
                block = full
            raw = zlib.compress(np.ascontiguousarray(block).tobytes(),
                                DEFAULT_GZIP)
            addr = self._write(raw, align=False)
            entries.append((self._chunk_key(len(raw), offset), addr))
            last = offset
        if not entries:
            return _UNDEF
        # the key after the last chunk: one chunk further on every axis
        right = self._chunk_key(0, tuple(o + c for o, c in zip(last, chunks)),
                                arr.dtype.itemsize)
        return self._write_btree(1, entries, right, _CHUNK_K)

    @staticmethod
    def _chunk_key(size: int, offset: Tuple[int, ...], tail: int = 0
                   ) -> bytes:
        return struct.pack(f"<II{len(offset) + 1}Q", size, 0, *offset, tail)

    def _write_btree(self, node_type: int, entries: List[Tuple[bytes, int]],
                     right: bytes, k: int) -> int:
        """v1 B-tree nodes over ``entries`` ([(left key, child)] in key
        order, ``right`` the key after the last), level by level, each
        node allocated at its full size of 2k children; returns the root's
        address."""
        key_size = len(right)
        node_size = 24 + (2 * k + 1) * key_size + 2 * k * 8
        level = 0
        while True:
            groups = [entries[i: i + 2 * k]
                      for i in range(0, max(len(entries), 1), 2 * k)]
            start = self._align()
            addrs = [start + j * node_size for j in range(len(groups))]
            parents = []
            for j, group in enumerate(groups):
                after = groups[j + 1][0][0] if j + 1 < len(groups) else right
                node = [b"TREE", struct.pack(
                    "<BBHQQ", node_type, level, len(group),
                    addrs[j - 1] if j else _UNDEF,
                    addrs[j + 1] if j + 1 < len(groups) else _UNDEF)]
                for key, child in group:
                    node += [key, struct.pack("<Q", child)]
                node.append(after)
                body = b"".join(node)
                self._write(body + bytes(node_size - len(body)), align=False)
                parents.append((group[0][0] if group else right, addrs[j]))
            if len(groups) == 1:
                return addrs[0]
            entries, level = parents, level + 1

    def _write_root_group(self) -> Tuple[int, int, int]:
        """The root group's local heap, symbol nodes, B-tree and object
        header; returns (header, B-tree, heap) addresses."""
        names = sorted(self._links)             # strcmp order
        heap, offsets = [bytes(8)], {}          # offset 0: the empty name
        pos = 8
        for name in names:
            entry = name + bytes(8 - len(name) % 8)
            offsets[name] = pos
            heap.append(entry)
            pos += len(entry)
        data = b"".join(heap)
        # the data segment right after the 32-byte header; free list 1:
        # no free block (HDF5's H5HL_FREE_NULL)
        heap_addr = self._align()
        self._write(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(data), 1, heap_addr + 32) + data)
        entries, prev = [], 0
        cap = 2 * _LEAF_K
        node_size = 8 + cap * _ENTRY_SIZE
        for i in range(0, len(names), cap):
            group = names[i: i + cap]
            body = b"SNOD" + struct.pack("<BBH", 1, 0, len(group)) + b"".join(
                struct.pack("<QQI4x16x", offsets[n], self._links[n], 0)
                for n in group)
            addr = self._write(body + bytes(node_size - len(body)))
            entries.append((struct.pack("<Q", prev), addr))
            prev = offsets[group[-1]]
        btree = self._write_btree(0, entries, struct.pack("<Q", prev),
                                  _GROUP_K)
        header = self._write(_object_header([_message(
            _SYMBOL_TABLE, 0, struct.pack("<QQ", btree, heap_addr))]))
        return header, btree, heap_addr

    def close(self):
        if self._f is None:
            return
        try:
            header, btree, heap = self._write_root_group()
            superblock = SIGNATURE + struct.pack(
                "<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _GROUP_K,
                0) + struct.pack("<QQQQ", 0, _UNDEF, self._pos, _UNDEF) \
                + struct.pack("<QQI4xQQ", 0, header, 1, btree, heap)
            self._f.seek(0)
            self._f.write(superblock)
        finally:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def File(path, mode: str = "r"):
    """``File(path, "r")`` reads, ``File(path, "w")`` writes (truncating)."""
    if mode == "r":
        return FileReader(path)
    if mode == "w":
        return FileWriter(path)
    raise ValueError(f"{os.fspath(path)}: mode {mode!r} is not supported "
                     f"('r' or 'w')")
