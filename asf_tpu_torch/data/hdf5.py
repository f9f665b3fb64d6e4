"""HDF5 archives of one-dimensional datasets, read and written with numpy
and the standard library (no h5py).

The subset is the one h5py writes by default (``libver="earliest"``) for
the EPIC-KITCHENS audio archive (``tools/wav_to_hdf5.py``): one dataset a
video in the root group. In the terms of the HDF5 file format
specification:

* superblock version 0 or 1, with its sizes of offsets and lengths and its
  group (and, in version 1, chunk index) B-tree K values;
* the root group as a symbol table: a version 1 B-tree of type 0 at any
  depth over symbol table nodes (``SNOD``), and the local heap of names;
* version 1 object headers, their continuation blocks followed;
* a rank 1 dataspace, and a fixed-point or IEEE floating-point datatype of
  either byte order;
* the data layout message version 3: contiguous (an undefined address, an
  empty or unallocated dataset, reads as zeros), or chunked under a version
  1 B-tree of type 1 at any depth (a missing chunk reads as zeros);
* the filter pipeline: none, deflate (``zlib``) and shuffle.

Anything else (superblock version 2 or 3, which ``libver="latest"``
writes; a shared or committed datatype; another filter; a rank other than
1; ...) raises a ``ValueError`` that names what it found.

``Archive`` reads: ``names()``, then ``dtype``, ``shape`` and ``chunks`` of a
dataset, then ``read(name, start, end)``. It opens the file on first use
(memory-mapped), in the process that uses it; a pickled ``Archive`` carries
its path only. ``Writer`` writes the same subset: superblock version 0, a
symbol-table root group whose B-tree and symbol table nodes take any number
of datasets (in strcmp order), each dataset contiguous or chunked without
filters, an edge chunk stored at full size.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_DATASPACE, _DATATYPE, _FILL_OLD, _FILL = 0x01, 0x03, 0x04, 0x05
_LINK, _EXTERNAL, _LAYOUT, _FILTERS = 0x06, 0x07, 0x08, 0x0B
_CONTINUATION, _SYMBOL_TABLE, _LINK_INFO = 0x10, 0x11, 0x02

_DEFLATE, _SHUFFLE = 1, 2
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32008: "bitshuffle", 32015: "zstd"}
_CLASS_NAMES = ("fixed-point", "floating-point", "time", "string", "bit field", "opaque",
                "compound", "reference", "enumerated", "variable-length", "array")
# IEEE layouts by size: precision, exponent location and size, mantissa
# location and size, exponent bias
_IEEE = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127), 8: (64, 52, 11, 0, 52, 1023)}

# the K values h5py's files take by default: 2K entries a node
_GROUP_LEAF_K, _GROUP_INTERNAL_K, _CHUNK_K = 4, 16, 32
_HEAP_FREE_NONE = 1  # the local heap's free-list offset when it has no free block
# the writer's superblock (version 0, 8-byte offsets): signature, versions and
# sizes, K values, flags, four addresses, the root group's symbol table entry
_SUPERBLOCK_SIZE = 8 + 8 + 4 + 4 + 4 * 8 + 40


def is_hdf5(path) -> bool:
    """Whether the file at ``path`` starts with the HDF5 signature."""
    with open(path, "rb") as f:
        return f.read(len(SIGNATURE)) == SIGNATURE


class _Dataset:
    __slots__ = ("dtype", "shape", "chunks", "address", "btree", "filters", "index")

    def __init__(self, dtype, n, chunks, address, btree, filters):
        self.dtype, self.shape, self.chunks = dtype, (n,), chunks
        self.address, self.btree, self.filters = address, btree, filters
        self.index = None  # {chunk offset: (address, stored bytes, filter mask)}, on first read


class Archive:
    """The one-dimensional datasets of the root group of an HDF5 file."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._mm = None
        self._links: dict | None = None  # name -> object header address, in strcmp order
        self._datasets: dict = {}

    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.__init__(state["path"])

    def close(self) -> None:
        self._mm, self._links, self._datasets = None, None, {}

    # -- the public reads --------------------------------------------------
    def names(self) -> list[str]:
        """The root group's link names, in strcmp order."""
        return list(self._group())

    def __contains__(self, name) -> bool:
        return name in self._group()

    def dtype(self, name: str) -> np.dtype:
        return self._dataset(name).dtype

    def shape(self, name: str) -> tuple[int]:
        return self._dataset(name).shape

    def chunks(self, name: str) -> tuple[int] | None:
        """The chunk shape of a chunked dataset, None for a contiguous one."""
        return self._dataset(name).chunks

    def read(self, name: str, start: int = 0, end: int | None = None) -> np.ndarray:
        """Elements ``[start, end)`` of dataset ``name`` (Python slice bounds:
        clipped to the dataset, negative from its end), in its stored dtype."""
        ds = self._dataset(name)
        a, b, _ = slice(start, end).indices(ds.shape[0])
        out = np.zeros(max(0, b - a), ds.dtype)
        if b <= a:
            return out
        isz = ds.dtype.itemsize
        if ds.chunks is None:
            if ds.address is not None:
                out[:] = self._bytes(ds.address + a * isz, (b - a) * isz).view(ds.dtype)
            return out
        c = ds.chunks[0]
        index = self._chunk_index(name, ds)
        for k in range(a // c, (b - 1) // c + 1):
            lo, hi = max(a, k * c), min(b, (k + 1) * c)
            hit = index.get(k * c)
            if hit is None:
                continue  # never written: zeros
            address, nbytes, mask = hit
            applied = [f for i, f in enumerate(ds.filters) if not mask >> i & 1]
            if applied:
                chunk = self._decode(bytes(self._bytes(address, nbytes)), applied, ds.dtype, c,
                                     name)
                out[lo - a : hi - a] = chunk[lo - k * c : hi - k * c]
            else:
                out[lo - a : hi - a] = self._bytes(address + (lo - k * c) * isz,
                                                   (hi - lo) * isz).view(ds.dtype)
        return out

    # -- the file ----------------------------------------------------------
    def _fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def _map(self):
        if self._mm is None:
            if not is_hdf5(self.path):
                self._fail("not an HDF5 file (it does not start with the HDF5 signature)")
            self._mm = np.memmap(self.path, np.uint8, "r")
            self._superblock()
        return self._mm

    def _bytes(self, address: int, n: int) -> np.ndarray:
        mm = self._map()
        if address < 0 or address + n > len(mm):
            self._fail(f"{n} bytes at {address} lie past the end of the file ({len(mm)} bytes)")
        return mm[address : address + n]

    def _u(self, pos: int, size: int) -> int:
        return int.from_bytes(self._bytes(pos, size).tobytes(), "little")

    def _addr(self, pos: int) -> int | None:
        """The address stored at ``pos`` made absolute; None where it is undefined."""
        v = self._u(pos, self._so)
        return None if v == (1 << 8 * self._so) - 1 else self._base + v

    def _superblock(self) -> None:
        mm = self._mm
        version = int(mm[8])
        if version not in (0, 1):
            self._fail(f"superblock version {version}: the reader takes versions 0 and 1, what "
                       "h5py writes with libver='earliest' (version 2 and 3 come from "
                       "libver='latest' or later)")
        self._so, self._sl = int(mm[13]), int(mm[14])
        if self._so not in (2, 4, 8) or self._sl not in (2, 4, 8):
            self._fail(f"sizes of offsets {self._so} and lengths {self._sl} (2, 4 or 8 each)")
        self.group_k = struct.unpack_from("<HH", mm, 16)  # (leaf, internal)
        pos = 24
        self.chunk_k = _CHUNK_K
        if version == 1:
            self.chunk_k = struct.unpack_from("<H", mm, 24)[0]
            pos = 28
        self._base = self._u(pos, self._so)
        root = pos + 4 * self._so  # after the superblock's four addresses
        self._root = self._addr(root + self._so)  # the entry's object header address

    # -- groups ------------------------------------------------------------
    def _group(self) -> dict:
        if self._links is None:
            self._map()
            msgs = self._messages(self._root)
            stab = [m for m in msgs if m[0] == _SYMBOL_TABLE]
            if not stab:
                kinds = sorted({m[0] for m in msgs} & {_LINK, _LINK_INFO})
                self._fail("the root group has no symbol table"
                           + (f" (link messages {kinds}: a new-style group)" if kinds else ""))
            pos = stab[0][2]
            btree, heap = self._addr(pos), self._addr(pos + self._so)
            names = self._heap(heap)
            links = {}
            for _, snod in self._btree(btree, 0, self._sl):
                for name, header in self._snod(snod, names):
                    links[name] = header
            self._links = links
        return self._links

    def _heap(self, address: int):
        """A function from a local heap offset to the name stored there."""
        if bytes(self._bytes(address, 4)) != b"HEAP":
            self._fail(f"no local heap at {address}")
        size = self._u(address + 8, self._sl)
        data = bytes(self._bytes(self._addr(address + 8 + 2 * self._sl), size))

        def name(offset: int) -> str:
            end = data.find(b"\0", offset)
            if offset >= size or end < 0:
                self._fail(f"a name at heap offset {offset} outside its {size} bytes")
            return data[offset:end].decode()
        return name

    def _btree(self, address: int, node_type: int, key_size: int, level: int | None = None):
        """(key position, child address) of every entry of the leaves under
        the version 1 B-tree node at ``address``, left to right."""
        if bytes(self._bytes(address, 4)) != b"TREE":
            self._fail(f"no B-tree node at {address}")
        kind, lvl = int(self._mm[address + 4]), int(self._mm[address + 5])
        if kind != node_type or (level is not None and lvl != level):
            self._fail(f"B-tree node at {address} of type {kind}, level {lvl} (expected type "
                       f"{node_type}" + (f", level {level})" if level is not None else ")"))
        n = self._u(address + 6, 2)
        width = 2 * (self.group_k[1] if node_type == 0 else self.chunk_k)
        if n > width:
            self._fail(f"B-tree node at {address} holds {n} entries, more than 2K = {width}")
        pos = address + 8 + 2 * self._so  # after the sibling addresses
        out = []
        for _ in range(n):
            child = self._addr(pos + key_size)
            if lvl == 0:
                out.append((pos, child))
            else:
                out += self._btree(child, node_type, key_size, lvl - 1)
            pos += key_size + self._so
        return out

    def _snod(self, address: int, names) -> list:
        if bytes(self._bytes(address, 4)) != b"SNOD":
            self._fail(f"no symbol table node at {address}")
        n = self._u(address + 6, 2)
        if n > 2 * self.group_k[0]:
            self._fail(f"symbol table node at {address} holds {n} entries, more than 2K = "
                       f"{2 * self.group_k[0]}")
        size = 2 * self._so + 24
        out = []
        for i in range(n):
            pos = address + 8 + i * size
            name = names(self._u(pos, self._so))
            if self._u(pos + 2 * self._so, 4) == 2:
                self._fail(f"{name!r} is a soft link")
            out.append((name, self._addr(pos + self._so)))
        return out

    # -- object headers and datasets --------------------------------------
    def _messages(self, address: int) -> list:
        """(type, flags, data position, size) of each message of the version
        1 object header at ``address``, continuation blocks followed."""
        if bytes(self._bytes(address, 4)) == b"OHDR":
            self._fail(f"a version 2 object header at {address} (libver='latest')")
        version = int(self._bytes(address, 1)[0])
        if version != 1:
            self._fail(f"object header version {version} at {address}")
        count = self._u(address + 2, 2)
        blocks = [(address + 16, self._u(address + 8, 4))]
        out = []
        while blocks and len(out) < count:
            pos, length = blocks.pop(0)
            end = pos + length
            while pos + 8 <= end and len(out) < count:
                mtype, size, flags = self._u(pos, 2), self._u(pos + 2, 2), int(self._mm[pos + 4])
                if mtype == _CONTINUATION:
                    blocks.append((self._addr(pos + 8), self._u(pos + 8 + self._so, self._sl)))
                out.append((mtype, flags, pos + 8, size))
                pos += 8 + size
        return out

    def _dataset(self, name: str) -> _Dataset:
        ds = self._datasets.get(name)
        if ds is None:
            links = self._group()
            if name not in links:
                raise KeyError(f"{self.path}: no dataset {name!r}")
            ds = self._datasets[name] = self._parse_dataset(name, links[name])
        return ds

    def _parse_dataset(self, name: str, address: int) -> _Dataset:
        msgs = {}
        for mtype, flags, pos, size in self._messages(address):
            if mtype == _DATATYPE and flags & 2:
                self._fail(f"{name!r} has a shared or committed datatype")
            if mtype in (_EXTERNAL, _SYMBOL_TABLE, _LINK_INFO):
                what = "is stored in external files" if mtype == _EXTERNAL else "is a group"
                self._fail(f"{name!r} {what}, not a dataset the reader takes")
            msgs.setdefault(mtype, pos)
        if _DATASPACE not in msgs or _DATATYPE not in msgs or _LAYOUT not in msgs:
            self._fail(f"{name!r} lacks a dataspace, datatype or layout message")
        n = self._dataspace(name, msgs[_DATASPACE])
        dtype = self._datatype(name, msgs[_DATATYPE])
        self._check_fill(name, msgs)
        filters = self._filters(name, msgs[_FILTERS]) if _FILTERS in msgs else []
        pos = msgs[_LAYOUT]
        version, kind = int(self._mm[pos]), int(self._mm[pos + 1])
        if version != 3:
            self._fail(f"{name!r}: data layout message version {version} (the reader takes 3)")
        if kind == 1:
            address = self._addr(pos + 2)
            if filters:
                self._fail(f"{name!r}: a filter pipeline on contiguous storage")
            return _Dataset(dtype, n, None, address, None, [])
        if kind != 2:
            self._fail(f"{name!r}: {'compact' if kind == 0 else f'class {kind}'} data layout "
                       "(the reader takes contiguous and chunked)")
        ndims = int(self._mm[pos + 2])
        btree = self._addr(pos + 3)
        dims = struct.unpack_from(f"<{ndims}I", self._mm, pos + 3 + self._so)
        if ndims != 2 or dims[1] != dtype.itemsize:
            self._fail(f"{name!r}: chunk dimensions {dims} of a rank 1 dataset of "
                       f"{dtype.itemsize}-byte elements")
        return _Dataset(dtype, n, (int(dims[0]),), None, btree, filters)

    def _dataspace(self, name: str, pos: int) -> int:
        version, rank = int(self._mm[pos]), int(self._mm[pos + 1])
        if version != 1:
            self._fail(f"{name!r}: dataspace message version {version} (the reader takes 1)")
        if rank != 1:
            self._fail(f"{name!r}: rank {rank} (the reader takes rank 1)")
        return self._u(pos + 8, self._sl)

    def _datatype(self, name: str, pos: int) -> np.dtype:
        head = self._u(pos, 4)
        cls, bits, size = head & 0xF, head >> 8, self._u(pos + 4, 4)
        offset, precision = struct.unpack_from("<HH", self._mm, pos + 8)
        order = ">" if bits & 1 else "<"
        if cls == 0:
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                self._fail(f"{name!r}: a {size}-byte integer of {precision} bits at bit {offset}")
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
        if cls == 1:
            props = (precision,) + struct.unpack_from("<4BI", self._mm, pos + 12)
            if bits & 0x40 or size not in _IEEE or offset or props != _IEEE[size] or (
                    bits >> 8 & 0xFF) != 8 * size - 1:
                self._fail(f"{name!r}: a {size}-byte float that is not IEEE {8 * size}-bit "
                           f"(properties {props}, bit field {bits:#x})")
            return np.dtype(f"{order}f{size}")
        what = _CLASS_NAMES[cls] if cls < len(_CLASS_NAMES) else f"class {cls}"
        self._fail(f"{name!r}: a {what} datatype (the reader takes fixed-point and IEEE "
                   "floating-point)")

    def _check_fill(self, name: str, msgs: dict) -> None:
        """Unwritten storage reads as zeros: a fill value other than zero raises."""
        value = b""
        if _FILL in msgs:
            pos = msgs[_FILL]
            version = int(self._mm[pos])
            if version not in (1, 2):
                self._fail(f"{name!r}: fill value message version {version} (the reader takes "
                           "1 and 2)")
            if self._mm[pos + 3]:  # defined
                value = bytes(self._bytes(pos + 8, self._u(pos + 4, 4)))
        elif _FILL_OLD in msgs:
            pos = msgs[_FILL_OLD]
            value = bytes(self._bytes(pos + 4, self._u(pos, 4)))
        if any(value):
            self._fail(f"{name!r}: a fill value other than zero ({value.hex()})")

    def _filters(self, name: str, pos: int) -> list[int]:
        version, n = int(self._mm[pos]), int(self._mm[pos + 1])
        if version != 1:
            self._fail(f"{name!r}: filter pipeline message version {version} (the reader "
                       "takes 1)")
        pos += 8
        ids = []
        for _ in range(n):  # id, name length, flags, client values; name; values
            fid, name_len, _, values = struct.unpack_from("<4H", self._mm, pos)
            if fid not in (_DEFLATE, _SHUFFLE):
                self._fail(f"{name!r}: filter {fid} ({_FILTER_NAMES.get(fid, 'unregistered')}); "
                           "the reader takes deflate and shuffle")
            pos += 8 + (name_len + 7) // 8 * 8 + 4 * (values + values % 2)
            ids.append(fid)
        return ids

    def _chunk_index(self, name: str, ds: _Dataset) -> dict:
        if ds.index is None:
            index = {}
            if ds.btree is not None:
                for pos, child in self._btree(ds.btree, 1, 8 + 8 * 2):
                    nbytes, mask, offset = struct.unpack_from("<IIQ", self._mm, pos)
                    if offset % ds.chunks[0]:
                        self._fail(f"{name!r}: a chunk at {offset}, not on the chunk grid")
                    index[offset] = (child, nbytes, mask)
            ds.index = index
        return ds.index

    def _decode(self, raw: bytes, filters: list, dtype: np.dtype, c: int, name: str):
        for fid in reversed(filters):
            if fid == _DEFLATE:
                raw = zlib.decompress(raw)
            else:  # shuffle: byte j of every element together, then byte j + 1
                isz, n = dtype.itemsize, len(raw) // dtype.itemsize
                body = np.frombuffer(raw, np.uint8, n * isz).reshape(isz, n).T
                raw = body.tobytes() + raw[n * isz :]
        if len(raw) != c * dtype.itemsize:
            self._fail(f"{name!r}: a chunk of {len(raw)} bytes, not {c * dtype.itemsize}")
        return np.frombuffer(raw, dtype)


class Writer:
    """Writes an HDF5 file whose root group holds one-dimensional datasets.

    ``add(name, data, chunks)`` writes a dataset at once (contiguous, or in
    chunks of ``chunks`` elements); ``close()`` writes the root group over
    every name added and the superblock. Use it as a context manager."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._f = open(self.path, "wb")
        self._f.write(bytes(_SUPERBLOCK_SIZE))
        self._end = self._f.tell()
        self._links: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self._f.close()

    def _write(self, data: bytes) -> int:
        """Writes ``data`` at the end of the file, 8-byte aligned; its address."""
        address = self._end
        pad = -len(data) % 8
        self._f.seek(address)
        self._f.write(data + bytes(pad))
        self._end = address + len(data) + pad
        return address

    def add(self, name: str, data, chunks: int | None = None) -> None:
        data = np.asarray(data)
        if not name or "/" in name or name == "." or name in self._links:
            raise ValueError(f"dataset name {name!r}: empty, with '/', '.' or taken")
        if data.ndim != 1:
            raise ValueError(f"{name!r}: a dataset is one-dimensional, got shape {data.shape}")
        if data.dtype.kind not in "iuf" or (data.dtype.kind == "f" and data.itemsize not in _IEEE):
            raise ValueError(f"{name!r}: dtype {data.dtype} (integers and IEEE floats)")
        n, isz = len(data), data.itemsize
        if chunks is None:
            layout = struct.pack("<BBQQ", 3, 1, self._write(data.tobytes()) if n else _UNDEF,
                                 n * isz)
        else:
            c = int(chunks)
            if not n or c < 1:
                raise ValueError(f"{name!r}: chunks of {c} elements of {n}")
            full = np.zeros(-(-n // c) * c, data.dtype)
            full[:n] = data
            keys, children = [], []
            for k in range(0, len(full), c):
                keys.append(struct.pack("<IIQQ", c * isz, 0, k, 0))
                children.append(self._write(full[k : k + c].tobytes()))
            keys.append(struct.pack("<IIQQ", 0, 0, len(full), isz))
            root = self._btree(1, keys, children, 2 * _CHUNK_K)
            layout = struct.pack("<BBBQII", 3, 2, 2, root, c, isz)
        messages = [
            (_DATASPACE, 0, struct.pack("<BBBxIQQ", 1, 1, 1, 0, n, n)),
            (_DATATYPE, 1, _datatype_message(data.dtype)),
            (_FILL, 1, struct.pack("<BBBBI", 2, 2 if chunks is None else 3, 2, 1, 0)),
            (_LAYOUT, 0, layout),
        ]
        self._links[name] = self._write(_object_header(messages))

    def _btree(self, node_type: int, keys: list, children: list, width: int) -> int:
        """Writes a version 1 B-tree over ``children`` (``keys`` has one more
        entry: key i bounds child i on the left, key i + 1 on the right),
        ``width`` children a node, level by level; the root's address."""
        key_size = len(keys[0])
        size = 8 + 2 * 8 + (width + 1) * key_size + width * 8  # 8-byte addresses
        level = 0
        while True:
            spans = [(i, min(i + width, len(children))) for i in range(0, len(children), width)]
            addresses = [self._end + j * (size + -size % 8) for j in range(len(spans))]
            for j, (a, b) in enumerate(spans):
                left = addresses[j - 1] if j else _UNDEF
                right = addresses[j + 1] if j + 1 < len(spans) else _UNDEF
                body = b"".join(keys[i] + struct.pack("<Q", children[i]) for i in range(a, b))
                node = (b"TREE" + struct.pack("<BBHQQ", node_type, level, b - a, left, right)
                        + body + keys[b])
                self._write(node + bytes(size - len(node)))
            if len(spans) == 1:
                return addresses[0]
            keys = [keys[a] for a, _ in spans] + [keys[-1]]
            children, level = addresses, level + 1

    def close(self) -> None:
        if self._f.closed:
            return
        names = sorted(self._links, key=lambda s: s.encode())
        heap, offsets = bytearray(8), {}  # offset 0: the empty name
        for name in names:
            offsets[name] = len(heap)
            raw = name.encode() + b"\0"
            heap += raw + bytes(-len(raw) % 8)
        heap_data = self._write(bytes(heap))
        heap_addr = self._write(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), _HEAP_FREE_NONE,
                                                        heap_data))
        per_node = 2 * _GROUP_LEAF_K
        snods, keys = [], [struct.pack("<Q", 0)]
        for i in range(0, max(1, len(names)), per_node):
            group = names[i : i + per_node]
            body = b"".join(struct.pack("<QQII16x", offsets[s], self._links[s], 0, 0)
                            for s in group)
            node = b"SNOD" + struct.pack("<BxH", 1, len(group)) + body
            snods.append(self._write(node + bytes(8 + per_node * 40 - len(node))))
            keys.append(struct.pack("<Q", offsets[group[-1]] if group else 0))
        btree = self._btree(0, keys, snods, 2 * _GROUP_INTERNAL_K)
        root = self._write(_object_header([(_SYMBOL_TABLE, 0, struct.pack("<QQ", btree,
                                                                           heap_addr))]))
        superblock = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                      + struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_INTERNAL_K, 0)
                      + struct.pack("<QQQQ", 0, _UNDEF, self._end, _UNDEF)
                      + struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap_addr))
        self._f.seek(0)
        self._f.write(superblock)
        self._f.close()


_UNDEF = (1 << 64) - 1


def _object_header(messages: list) -> bytes:
    """A version 1 object header of ``(type, flags, data)`` messages, each
    padded to 8 bytes."""
    body = b""
    for mtype, flags, data in messages:
        data += bytes(-len(data) % 8)
        body += struct.pack("<HHB3x", mtype, len(data), flags) + data
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    order = 1 if dtype.str[0] == ">" else 0
    if dtype.kind in "iu":
        bits = order | (8 if dtype.kind == "i" else 0)
        return struct.pack("<I I HH", 0x10 | bits << 8, size, 0, 8 * size)
    precision, exp_loc, exp_size, mant_loc, mant_size, bias = _IEEE[size]
    bits = order | 0x20 | (8 * size - 1) << 8  # implied leading mantissa bit; sign bit
    return struct.pack("<I I HH 4B I", 0x11 | bits << 8, size, 0, precision, exp_loc, exp_size,
                       mant_loc, mant_size, bias)
