"""MMseqs2-style database reader/writer.

Format parity with the reference's C-ABI reader/writer
(database_reader.cpp / database_writer.cpp):

  <db>         concatenated entry payloads
  <db>.index   text lines "id\toffset\tlength\n", sorted by id on close
  <db>.lookup  text lines "id\tname\t0\n"
  <db>.dbtype  4 bytes, little-endian int 12 (generic)

Reader memory-maps the data file and serves entries by position or by name.
Used by the Python API (foldcomp.open) and by the sharded input pipeline
(foldcomp_tpu.parallel.pipeline, not ported yet), which hands each host a
contiguous range of index entries.

The port's own copy of `foldcomp_tpu/io/db.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

import mmap
import os

import numpy as np

GENERIC_DB_TYPE = 12


class DatabaseReader:
    """Reader over the native C runtime (native/fcio.c fcdb_reader_*) with a
    pure-Python mmap fallback (database_reader.cpp:60-167 parity)."""

    CACHE_MAGIC = b"FCIDX1\x00\x00"

    def __init__(self, data_name: str, index_name: str | None = None,
                 use_lookup: bool = False, use_cache: bool = False):
        self.data_name = data_name
        index_name = index_name or data_name + ".index"
        self._h = None
        self._lib = None
        self._mm = None
        self._file = None
        if use_cache and self._load_cache(index_name):
            self._open_data_mmap(data_name)
            self._init_lookup(data_name, use_lookup)
            return
        try:
            from ..native import get_lib
            lib = get_lib()
        except Exception:
            lib = None
        if lib is not None:
            h = lib.fcdb_reader_open(data_name.encode(),
                                     index_name.encode(), 1)
            if h:
                self._h = h
                self._lib = lib
        if self._h is None:
            ids, offsets, lengths = [], [], []
            with open(index_name, "r") as fh:
                for line in fh:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) < 3:
                        continue
                    ids.append(int(parts[0]))
                    offsets.append(int(parts[1]))
                    lengths.append(int(parts[2]))
            order = np.argsort(np.asarray(ids, np.int64), kind="stable")
            self.ids = np.asarray(ids, np.int64)[order]
            self.offsets = np.asarray(offsets, np.int64)[order]
            self.lengths = np.asarray(lengths, np.int64)[order]
            self._open_data_mmap(data_name)
        if use_cache:
            self._save_cache(index_name)
        self._init_lookup(data_name, use_lookup)

    def _open_data_mmap(self, data_name: str):
        self._file = open(data_name, "rb")
        size = os.fstat(self._file.fileno()).st_size
        self._mm = mmap.mmap(self._file.fileno(), size,
                             access=mmap.ACCESS_READ) if size else b""

    def _init_lookup(self, data_name: str, use_lookup: bool):
        self._name_to_key = None
        self._key_to_name = None
        if use_lookup or os.path.exists(data_name + ".lookup"):
            self._load_lookup(data_name + ".lookup")

    def _load_cache(self, index_name: str) -> bool:
        """Binary index cache (<index>.cache, database_reader.cpp:397-420
        equivalent). Valid only when newer than the text index."""
        cache = index_name + ".cache"
        try:
            if os.path.getmtime(cache) < os.path.getmtime(index_name):
                return False
            with open(cache, "rb") as fh:
                if fh.read(8) != self.CACHE_MAGIC:
                    return False
                n = int.from_bytes(fh.read(8), "little")
                self.ids = np.fromfile(fh, np.int64, n)
                self.offsets = np.fromfile(fh, np.int64, n)
                self.lengths = np.fromfile(fh, np.int64, n)
            return len(self.ids) == n
        except OSError:
            return False

    def _save_cache(self, index_name: str):
        cache = index_name + ".cache"
        if os.path.exists(cache) and \
                os.path.getmtime(cache) >= os.path.getmtime(index_name):
            return
        n = len(self)
        if self._h is not None:
            ids32 = np.empty(n, np.uint32)
            offsets = np.empty(n, np.int64)
            lengths = np.empty(n, np.int64)
            self._lib.fcdb_reader_dump(self._h, ids32, offsets, lengths)
            ids = ids32.astype(np.int64)
        else:
            ids, offsets, lengths = self.ids, self.offsets, self.lengths
        try:
            with open(cache, "wb") as fh:
                fh.write(self.CACHE_MAGIC)
                fh.write(n.to_bytes(8, "little"))
                ids.astype(np.int64).tofile(fh)
                offsets.astype(np.int64).tofile(fh)
                lengths.astype(np.int64).tofile(fh)
        except OSError:
            pass

    def _load_lookup(self, path: str):
        if not os.path.exists(path):
            return
        self._name_to_key = {}
        self._key_to_name = {}
        with open(path, "r") as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    key = int(parts[0])
                    self._name_to_key.setdefault(parts[1], key)
                    self._key_to_name.setdefault(key, parts[1])

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.fcdb_reader_size(self._h))
        return len(self.ids)

    def get_data(self, pos: int) -> bytes:
        if self._h is not None:
            import ctypes
            ptr = ctypes.c_char_p()
            ln = ctypes.c_int64()
            if self._lib.fcdb_reader_get(self._h, pos, ctypes.byref(ptr),
                                         ctypes.byref(ln)) != 0:
                raise IndexError(pos)
            return ctypes.string_at(ptr, ln.value)
        off = int(self.offsets[pos])
        ln = int(self.lengths[pos])
        return bytes(self._mm[off:off + ln])

    def get_key(self, pos: int) -> int:
        if self._h is not None:
            return int(self._lib.fcdb_reader_key(self._h, pos))
        return int(self.ids[pos])

    def get_length(self, pos: int) -> int:
        if self._h is not None:
            return int(self._lib.fcdb_reader_length(self._h, pos))
        return int(self.lengths[pos])

    def get_offset(self, pos: int) -> int:
        if self._h is not None:
            return int(self._lib.fcdb_reader_offset(self._h, pos))
        return int(self.offsets[pos])

    def position_of_key(self, key: int) -> int:
        """reader_get_id: binary search by key; -1 if missing."""
        if self._h is not None:
            return int(self._lib.fcdb_reader_id(self._h, key))
        i = int(np.searchsorted(self.ids, key))
        if i < len(self.ids) and self.ids[i] == key:
            return i
        return -1

    def lookup_key(self, name: str) -> int:
        """reader_lookup_entry: name -> key via .lookup; UINT32_MAX if missing."""
        if self._name_to_key is None:
            return 0xFFFFFFFF
        return self._name_to_key.get(name, 0xFFFFFFFF)

    def name_of_key(self, key: int) -> str | None:
        if self._key_to_name is None:
            return None
        return self._key_to_name.get(key)

    def entries(self):
        """Iterate (key, name_or_None, payload) in id order."""
        for pos in range(len(self)):
            key = self.get_key(pos)
            yield key, self.name_of_key(key), self.get_data(pos)

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._lib.fcdb_reader_close(self._h)
            self._h = None
        if getattr(self, "_mm", None) is not None and self._mm != b"":
            self._mm.close()
        if getattr(self, "_file", None) is not None:
            self._file.close()
        self._mm = None
        self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DatabaseWriter:
    """Append-only writer (database_writer.cpp:36-98).

    Backed by the native C writer (native/fcio.c fcdb_writer_*) when the
    library is available — identical on-disk output (index/lookup/dbtype
    formats and the stable key sort on close), with `_h` exposed so the
    GIL-free db->db chunk loops (fcz_db_decode_range) can append without
    crossing back into Python. Falls back to pure Python."""

    def __init__(self, data_name: str, index_name: str | None = None):
        self.data_name = data_name
        self.index_name = index_name or data_name + ".index"
        self._data = None
        self._h = None
        self._lib = None
        with open(data_name + ".dbtype", "wb") as fh:
            fh.write(GENERIC_DB_TYPE.to_bytes(4, "little"))
        if index_name is None:
            try:
                from ..native import get_lib
                lib = get_lib()
            except Exception:
                lib = None
            if lib is not None:
                h = lib.fcdb_writer_open(data_name.encode())
                if h:
                    self._h = h
                    self._lib = lib
                    return
        self._data = open(data_name, "wb")
        self._entries = []  # (id, offset, length, name)
        self._sorted = True

    def append(self, data: bytes, key: int, name: str):
        if self._h is not None:
            if self._lib.fcdb_writer_append(self._h, data, len(data), key,
                                            name.encode()) != 0:
                raise OSError(f"append to {self.data_name} failed")
            return
        offset = self._data.tell()
        self._data.write(data)
        if self._entries and self._entries[-1][0] >= key:
            self._sorted = False
        self._entries.append((key, offset, len(data), name))

    def close(self):
        if self._h is not None:
            h, self._h = self._h, None
            if self._lib.fcdb_writer_close(h) != 0:
                raise OSError(f"closing {self.data_name} failed")
            return
        if self._data is None:
            return
        entries = self._entries
        if not self._sorted:
            entries = sorted(entries, key=lambda e: e[0])
        with open(self.index_name, "w") as idx, \
                open(self.data_name + ".lookup", "w") as lkp:
            for key, offset, length, name in entries:
                idx.write(f"{key}\t{offset}\t{length}\n")
                lkp.write(f"{key}\t{name}\t0\n")
        self._data.close()
        self._data = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def is_database(path: str) -> bool:
    return os.path.exists(path + ".dbtype")
