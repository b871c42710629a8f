"""Read-only OCDBT key-value store: the storage under an orbax checkpoint.

The JAX package saves its priors with orbax, which stores every array as
zarr chunks in an OCDBT B-tree written by tensorstore.  This module reads
such a tree with numpy and ``ctypes`` (libzstd), so the port needs neither
JAX, orbax nor tensorstore.  It reads what this repository's checkpoints
hold: a single-file manifest (``manifest.ocdbt``) whose version list holds
the latest version inline, B-tree nodes of any height, values inline in a
leaf or stored in data files.

Layout (integers little-endian, "varint" LEB128; a list of n fields is
stored field by field, all n of one field, then the next):

- Manifest and B-tree node: magic (uint32 big-endian, 0x0cdb3a2a manifest,
  0x0cdb20de node), total length (uint64), format version (varint, 0),
  compression (varint: 0 none, 1 zstd), the body (one zstd frame if
  compressed), CRC-32C of all preceding bytes (uint32).
- Manifest body: config (uuid[16], manifest kind varint (0: versions
  inline), max inline value bytes varint, max decoded node bytes varint,
  version tree arity log2 uint8, compression varint and, for zstd, its level
  int32), a data file table, then n versions: generation, root height
  (uint8), root node's data file id, offset and length, key count, tree
  bytes, indirect value bytes, commit time (uint64).  The last is the
  latest; a root offset of 2**64 - 1 marks an empty tree.
- Data file table: n, prefix length shared with the previous path
  (n - 1 of them), suffix length, base path length, then the suffixes.
  Paths are relative to the tree's root directory.
- B-tree node body: height (uint8), a data file table, n entries' keys
  (prefix length shared with the previous key (n - 1), suffix length, for
  an interior node the length of the key prefix that all keys of the
  entry's subtree share, then the suffixes).  A leaf then has each value's
  length, kind (0 inline, 1 in a data file), the data file id and offset of
  each stored value, and the inline values back to back.  An interior node
  has each child's data file id, offset and length, key count, tree bytes
  and indirect value bytes; a child's keys omit the shared prefix.

Every fault (a missing or short file, a bad magic, length, checksum or
zstd frame, an unsupported variant) raises `FormatError` naming the file.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_NODE = (1 << 64) - 1
_HEADER = 14            # magic, length, version and compression, one byte each


class FormatError(ValueError):
    """A checkpoint tree that this reader cannot read as it stands."""


class _InBuf(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuf(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=None)
def _libzstd():
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise OSError(f"cannot load the zstd library ({name}): {e}") from e
    lib.ZSTD_createDStream.restype = ctypes.c_void_p
    lib.ZSTD_createDStream.argtypes = []
    lib.ZSTD_freeDStream.restype = ctypes.c_size_t
    lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_initDStream.restype = ctypes.c_size_t
    lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    lib.ZSTD_decompressStream.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_OutBuf), ctypes.POINTER(_InBuf)]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    return lib


def unzstd(data: bytes, where: str, size: Optional[int] = None) -> bytes:
    """The content of `data`, which must be exactly one complete zstd frame
    (of `size` bytes of content where given)."""
    lib = _libzstd()
    src = ctypes.create_string_buffer(data, len(data))
    inb = _InBuf(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    step = size + 1 if size is not None else 1 << 17
    out: List[bytes] = []
    total = 0
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        lib.ZSTD_initDStream(stream)
        while True:
            buf = ctypes.create_string_buffer(step)
            outb = _OutBuf(ctypes.cast(buf, ctypes.c_void_p), step, 0)
            ret = lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                            ctypes.byref(inb))
            if lib.ZSTD_isError(ret):
                raise FormatError(f"{where}: bad zstd frame: "
                                  f"{lib.ZSTD_getErrorName(ret).decode()}")
            out.append(buf.raw[:outb.pos])
            total += outb.pos
            if size is not None and total > size:
                raise FormatError(f"{where}: zstd frame holds more than the "
                                  f"{size} bytes expected")
            if ret == 0:
                break
            if inb.pos == inb.size and outb.pos < step:
                raise FormatError(f"{where}: zstd frame ends early")
    finally:
        lib.ZSTD_freeDStream(stream)
    if inb.pos != len(data):
        raise FormatError(f"{where}: {len(data) - inb.pos} bytes after the "
                          "zstd frame")
    if size is not None and total != size:
        raise FormatError(f"{where}: zstd frame holds {total} bytes, "
                          f"{size} expected")
    return b"".join(out)


@functools.lru_cache(maxsize=None)
def _crc32c_table() -> Tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT's trailers hold it."""
    table, crc = _crc32c_table(), 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads fields off `data` in order; running past its end raises."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise FormatError(f"{self.where}: ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = 0
        for shift in range(0, 70, 7):
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                if value >= 1 << 64:
                    break
                return value
        raise FormatError(f"{self.where}: varint out of range")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise FormatError(f"{self.where}: {len(self.data) - self.pos} "
                              "bytes left over")


class _Ref(NamedTuple):
    """Bytes [offset, offset + length) of a data file (path relative to
    the tree's root)."""

    path: str
    offset: int
    length: int


def _read(root: str, ref: _Ref) -> bytes:
    path = os.path.join(root, ref.path)
    try:
        with open(path, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
    except FileNotFoundError:
        raise FormatError(f"{path}: data file missing") from None
    if len(data) != ref.length:
        raise FormatError(f"{path}: {ref.length} bytes at {ref.offset} "
                          f"expected, the file holds {len(data)}")
    return data


def _framed(root: str, ref: _Ref, magic: int) -> bytes:
    """The checked, decompressed body of a manifest or B-tree node."""
    data = _read(root, ref)
    where = f"{os.path.join(root, ref.path)}@{ref.offset}"
    if len(data) < _HEADER + 4:
        raise FormatError(f"{where}: {len(data)} bytes, too short")
    if int.from_bytes(data[:4], "big") != magic:
        raise FormatError(f"{where}: bad magic {data[:4].hex()}, "
                          f"{magic:08x} expected")
    cur = _Cursor(data[:-4], where)
    cur.take(4)
    length = int.from_bytes(cur.take(8), "little")
    if length != len(data):
        raise FormatError(f"{where}: header says {length} bytes, "
                          f"{len(data)} read")
    if int.from_bytes(data[-4:], "little") != _crc32c(data[:-4]):
        raise FormatError(f"{where}: checksum mismatch")
    version, compression = cur.varint(), cur.varint()
    if version != 0 or compression not in (0, 1):
        raise FormatError(f"{where}: unsupported format version {version} "
                          f"or compression {compression}")
    body = data[cur.pos:-4]
    return unzstd(body, where) if compression == 1 else body


def _data_files(cur: _Cursor) -> List[str]:
    n = cur.varint()
    shared = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths: List[str] = []
    for i in range(n):
        prev = paths[-1] if paths else ""
        if shared[i] > len(prev):
            raise FormatError(f"{cur.where}: bad data file table")
        path = prev[:shared[i]] + cur.take(suffix[i]).decode()
        if (base[i] > len(path) or path.startswith("/")
                or ".." in path.split("/")):
            raise FormatError(f"{cur.where}: bad data file path {path!r}")
        paths.append(path)
    return paths


def _keys(cur: _Cursor, n: int, interior: bool):
    shared = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else None
    keys: List[bytes] = []
    for i in range(n):
        prev = keys[-1] if keys else b""
        if shared[i] > len(prev):
            raise FormatError(f"{cur.where}: bad key prefix")
        keys.append(prev[:shared[i]] + cur.take(suffix[i]))
    return keys, common


def _file(files: List[str], i: int, where: str) -> str:
    if i >= len(files):
        raise FormatError(f"{where}: data file id {i} of {len(files)}")
    return files[i]


def _root(root: str) -> Optional[Tuple[_Ref, int]]:
    """(root node, its height) of the latest version; None when empty."""
    where = os.path.join(root, "manifest.ocdbt")
    if not os.path.isfile(where):
        raise FormatError(f"{where}: manifest missing")
    size = os.path.getsize(where)
    cur = _Cursor(_framed(root, _Ref("manifest.ocdbt", 0, size),
                          MANIFEST_MAGIC), where)
    cur.take(16)                                    # uuid
    kind = cur.varint()
    if kind != 0:
        raise FormatError(f"{where}: manifest kind {kind}; only versions "
                          "held in the manifest itself (0) are read")
    cur.varint(), cur.varint(), cur.u8()            # node sizes, arity
    compression = cur.varint()
    if compression == 1:
        cur.take(4)                                 # zstd level
    elif compression != 0:
        raise FormatError(f"{where}: unknown compression {compression}")
    files = _data_files(cur)
    n = cur.varint()
    if n == 0:
        return None
    cur.varints(n)                                  # generation numbers
    heights = [cur.u8() for _ in range(n)]
    ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
    if offsets[-1] == _NO_NODE:
        return None
    return _Ref(_file(files, ids[-1], where), offsets[-1], lengths[-1]), \
        heights[-1]


Value = Union[bytes, _Ref]


def _walk(root: str, ref: _Ref, height: int, prefix: bytes,
          out: Dict[bytes, Value]) -> None:
    where = f"{os.path.join(root, ref.path)}@{ref.offset}"
    cur = _Cursor(_framed(root, ref, NODE_MAGIC), where)
    got = cur.u8()
    if got != height:
        raise FormatError(f"{where}: node of height {got}, {height} expected")
    files = _data_files(cur)
    n = cur.varint()
    keys, common = _keys(cur, n, height > 0)
    if height > 0:
        ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)                          # subtree statistics
        cur.end()
        for key, c, i, off, ln in zip(keys, common, ids, offsets, lengths):
            if c > len(key):
                raise FormatError(f"{where}: bad subtree prefix")
            _walk(root, _Ref(_file(files, i, where), off, ln), height - 1,
                  prefix + key[:c], out)
        return
    lengths = cur.varints(n)
    kinds = cur.varints(n)
    if any(k not in (0, 1) for k in kinds):
        raise FormatError(f"{where}: unknown value kind")
    stored = [i for i, k in enumerate(kinds) if k == 1]
    ids, offsets = cur.varints(len(stored)), cur.varints(len(stored))
    refs = {i: _Ref(_file(files, f, where), off, lengths[i])
            for i, f, off in zip(stored, ids, offsets)}
    for i, key in enumerate(keys):
        out[prefix + key] = refs[i] if i in refs else cur.take(lengths[i])
    cur.end()


class OcdbtReader:
    """The keys and values of the OCDBT tree under directory `root`."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._values: Dict[bytes, Value] = {}
        top = _root(self.root)
        if top is not None:
            _walk(self.root, top[0], top[1], b"", self._values)

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def __getitem__(self, key: str) -> bytes:
        try:
            value = self._values[key.encode()]
        except KeyError:
            raise FormatError(f"{self.root}: no key {key!r}") from None
        return value if isinstance(value, bytes) else _read(self.root, value)
