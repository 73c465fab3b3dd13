"""HDF5 feature files written in plain Python and numpy, without h5py.

Frozen copy of the writer of ``navillm_tpu_torch/utils/hdf5.py`` (commit
20b2d57): superblock v0, a symbol-table root group, version-1 object
headers, and per dataset a chunked layout deflated at h5py's default
level with h5py's chunk shape and a v1 B-tree chunk index, as the paper's
extractors lay out their ``.hdf5`` feature files. The benchmark writes its
view features with it, so that a later change to the program's writer
cannot move what the program's reader is given.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
_DATASPACE, _DATATYPE, _FILL, _LAYOUT = 0x1, 0x3, 0x5, 0x8
_PIPELINE, _SYMBOL_TABLE = 0xB, 0x11
_DEFLATE = 1

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


class File:
    """An HDF5 file opened for writing. Each dataset
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
