"""A read-only OCDBT key-value store (tensorstore's on-disk B+tree).

Orbax writes a checkpoint's arrays into one: a ``manifest.ocdbt`` at the
root of the step directory, B-tree nodes and values in data files under
``d/`` and ``ocdbt.process_0/d/``.  This module reads it with the
standard library and numpy alone::

    store = OcdbtStore("pretrained/synthetic-v9p/best/step_00000500")
    store.list()                  # every key, sorted
    store.read(b"step/.zarray")   # the value's bytes

Every encoded object (the manifest, a B-tree node) is an envelope: the
magic number (big-endian), its own length (u64, little-endian), a format
version and a compression (0 none, 1 zstd) as varints, the body, and a
CRC-32C (Castagnoli) of everything before it.  Integers in a body are
varints, written column by column (every entry's first field, then every
entry's second, ...).

* manifest body: the config (uuid, manifest kind, the inline-value and
  node-size limits, the version-tree arity, the node compression), a
  data-file table, the latest versions (generation, root height, root
  node reference and its statistics, commit time) and references to
  version-tree nodes holding older ones.  The last version is the
  store's content; a root of length 2**64 - 1 is an empty tree.
* B-tree node body: its height, a data-file table, its entries.  Keys
  are prefix-compressed against the entry before.  An interior entry
  points at a child node and keeps a subtree prefix: the first bytes of
  its key, which the child's keys leave out.  A leaf entry holds its
  value inline or as (data file, offset, length).
* data-file table: each file's path is ``base path + relative path``
  under the store's directory, prefix-compressed against the file
  before.

Only a manifest of kind "single" (what Orbax writes) is read; anything
that breaks the format raises :class:`OcdbtError`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple, Union

from deeplocalproteindocking_torch.utils.zstd import ZstdError, decompress

__all__ = ["OcdbtError", "OcdbtStore", "crc32c"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_BTREE_MAGIC = 0x0CDB20DE
_EMPTY = (1 << 64) - 1


class OcdbtError(ValueError):
    """An OCDBT store that is damaged or of a kind this reader does not
    read."""


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    t = _CRC_TABLE
    c = 0xFFFFFFFF
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Varints and fixed-width fields from the front of a body."""

    def __init__(self, buf: bytes):
        self.buf, self.p = buf, 0

    def varint(self) -> int:
        buf, p = self.buf, self.p
        v = shift = 0
        while True:
            if p >= len(buf):
                raise OcdbtError("varint runs past its body")
            b = buf[p]
            p += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
            if shift > 63:
                raise OcdbtError("varint longer than 64 bits")
        self.p = p
        return v

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.buf):
            raise OcdbtError("field runs past its body")
        out = self.buf[self.p:self.p + n]
        self.p += n
        return out

    def fixed(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def done(self, what: str) -> None:
        if self.p != len(self.buf):
            raise OcdbtError(f"{len(self.buf) - self.p} bytes after the "
                             f"{what}")


def _envelope(blob: bytes, magic: int, what: str) -> bytes:
    """The body of an encoded manifest or node, checked."""
    if len(blob) < 18:
        raise OcdbtError(f"{what}: {len(blob)} bytes is too short")
    if int.from_bytes(blob[:4], "big") != magic:
        raise OcdbtError(f"{what}: bad magic number")
    if int.from_bytes(blob[4:12], "little") != len(blob):
        raise OcdbtError(f"{what}: length field says "
                         f"{int.from_bytes(blob[4:12], 'little')}, "
                         f"it is {len(blob)} bytes")
    if crc32c(blob[:-4]) != int.from_bytes(blob[-4:], "little"):
        raise OcdbtError(f"{what}: CRC-32C differs")
    r = _Reader(blob[:-4])
    r.p = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = blob[r.p:-4]
    if compression == 1:
        try:
            return decompress(body)
        except ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from e
    if compression != 0:
        raise OcdbtError(f"{what}: compression {compression}")
    return body


def _data_files(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)      # base-path lengths: where each path splits
    paths, prev = [], b""
    for k in range(n):
        if prefix[k] > len(prev):
            raise OcdbtError("data-file path prefix longer than the path "
                             "before it")
        prev = prev[:prefix[k]] + r.take(suffix[k])
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int) -> Tuple[List[int], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    return prefix, suffix


def _key_data(r: _Reader, prefix, suffix) -> List[bytes]:
    keys, prev = [], b""
    for k in range(len(suffix)):
        if prefix[k] > len(prev):
            raise OcdbtError("key prefix longer than the key before it")
        prev = prev[:prefix[k]] + r.take(suffix[k])
        keys.append(prev)
    return keys


# A value: its bytes, or (data-file path, offset, length).
Value = Union[bytes, Tuple[str, int, int]]


class OcdbtStore:
    """The latest version of the OCDBT store in directory ``root``."""

    def __init__(self, root: str | os.PathLike):
        self.root = os.fspath(root)
        blob = self._read_file("manifest.ocdbt")
        r = _Reader(_envelope(blob, _MANIFEST_MAGIC, "manifest"))
        r.take(16)            # the store's uuid
        kind = r.varint()
        if kind != 0:
            raise OcdbtError(f"manifest kind {kind}: only a single-file "
                             f"manifest is read")
        r.varint()            # max_inline_value_bytes: a writer's limit
        self.max_decoded_node_bytes = r.varint()
        r.fixed(1)            # version_tree_arity_log2
        compression = r.varint()
        if compression == 1:
            r.fixed(4)            # the writer's zstd level
        elif compression != 0:
            raise OcdbtError(f"node compression {compression}")
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            raise OcdbtError("manifest without a version")
        generation = r.varints(n)
        height = [r.fixed(1) for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        self.num_keys = r.varints(n)[-1]
        r.varints(n)          # num_tree_bytes
        r.varints(n)          # num_indirect_value_bytes
        [r.fixed(8) for _ in range(n)]    # commit times
        m = r.varint()        # version-tree nodes: older versions only
        for _ in range(5):
            r.varints(m)
        [r.fixed(8) for _ in range(m)]
        [r.fixed(1) for _ in range(m)]
        r.done("manifest")
        self.generation = generation[-1]
        self._entries: Dict[bytes, Value] = {}
        if length[-1] != _EMPTY:
            self._walk(self._ref(files, file_id[-1], offset[-1],
                                 length[-1]), height[-1], b"")
        if len(self._entries) != self.num_keys:
            raise OcdbtError(f"tree holds {len(self._entries)} keys, the "
                             f"manifest says {self.num_keys}")

    def _path(self, rel: str) -> str:
        parts = rel.split("/")
        if rel.startswith("/") or ".." in parts:
            raise OcdbtError(f"data-file path {rel!r} leaves the store")
        return os.path.join(self.root, *parts)

    def _ref(self, files, file_id: int, offset: int, length: int):
        if file_id >= len(files):
            raise OcdbtError(f"data file {file_id} of {len(files)}")
        return files[file_id], offset, length

    def _read_file(self, rel: str, offset: int = 0,
                   length: int = -1) -> bytes:
        """``length`` bytes of file ``rel`` from ``offset`` (all to its
        end by default).  A file that cannot be opened is a damaged store
        (:class:`OcdbtError`), not a missing checkpoint."""
        try:
            with open(self._path(rel), "rb") as f:
                f.seek(offset)
                return f.read(length)
        except OSError as e:
            raise OcdbtError(f"{self.root}: {e}") from e

    def _read_range(self, rel: str, offset: int, length: int) -> bytes:
        out = self._read_file(rel, offset, length)
        if len(out) != length:
            raise OcdbtError(f"{rel}: {length} bytes at {offset} run past "
                             f"the file")
        return out

    def _walk(self, ref, height: int, prefix: bytes) -> None:
        body = _envelope(self._read_range(*ref), _BTREE_MAGIC,
                         f"B-tree node {ref[0]}@{ref[1]}")
        if len(body) > self.max_decoded_node_bytes:
            raise OcdbtError("B-tree node above the store's node size")
        r = _Reader(body)
        if r.fixed(1) != height:
            raise OcdbtError(f"B-tree node of height {body[0]} where "
                             f"{height} was expected")
        files = _data_files(r)
        n = r.varint()
        kp, ks = _keys(r, n)
        if height:
            common = r.varints(n)
            keys = _key_data(r, kp, ks)
            file_id, offset, length = r.varints(n), r.varints(n), \
                r.varints(n)
            for _ in range(3):        # statistics
                r.varints(n)
            r.done("B-tree node")
            for k in range(n):
                if common[k] > len(keys[k]):
                    raise OcdbtError("subtree prefix longer than its key")
                self._walk(self._ref(files, file_id[k], offset[k],
                                     length[k]),
                           height - 1, prefix + keys[k][:common[k]])
            return
        keys = _key_data(r, kp, ks)
        length = r.varints(n)
        kind = r.varints(n)
        n_ind = sum(kind)
        if any(k > 1 for k in kind):
            raise OcdbtError("unknown value kind")
        file_id, offset = r.varints(n_ind), r.varints(n_ind)
        i = 0
        for k in range(n):
            key = prefix + keys[k]
            if kind[k]:
                self._entries[key] = self._ref(files, file_id[i], offset[i],
                                               length[k])
                i += 1
            else:
                self._entries[key] = r.take(length[k])
        r.done("B-tree node")

    def list(self) -> List[bytes]:
        """Every key of the store, sorted."""
        return sorted(self._entries)

    def read(self, key: Union[bytes, str]) -> bytes:
        """The value of ``key``; ``KeyError`` if the store has none."""
        v = self._entries[_as_key(key)]
        return v if isinstance(v, bytes) else self._read_range(*v)


def _as_key(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)
