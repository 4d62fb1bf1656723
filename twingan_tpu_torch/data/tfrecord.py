"""TFRecord container reader/writer.

Wire format per record (identical to TensorFlow's):
    uint64 length (LE) | uint32 masked_crc32c(length bytes) |
    payload[length]    | uint32 masked_crc32c(payload)
masked = ((crc >> 15) | (crc << 17)) + 0xa282ead8.

A copy of ``twingan_tpu/data/tfrecord.py`` on the port's own native
library. The reader memory-maps the file and uses the native C++ scanner
(``twingan_tpu_torch/native``) for the offset index + CRC verification; a
pure-Python path covers environments without a toolchain. Random access by index makes
shuffled epochs cheap (the reference's slim readers are sequential-only).
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator

import numpy as np

from twingan_tpu_torch import native

_MASK_DELTA = 0xA282EAD8

_SW_TABLE: np.ndarray | None = None


def _sw_table() -> np.ndarray:
    global _SW_TABLE
    if _SW_TABLE is None:
        table = np.zeros(256, np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            table[i] = c
        _SW_TABLE = table
    return _SW_TABLE


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli). Hardware via the native lib when available."""
    lib = native.load()
    if lib is not None:
        return lib.twin_crc32c(bytes(data), len(data))
    table = _sw_table()
    crc = 0xFFFFFFFF
    for b in bytes(data):
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


class TFRecordWriter:
    """Sequential record writer (reference: tf.python_io.TFRecordWriter)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TFRecordReader:
    """Memory-mapped random-access record reader."""

    def __init__(self, path: str, verify: bool = False):
        self.path = path
        self._file = open(path, "rb")
        size = os.fstat(self._file.fileno()).st_size
        self._mm = mmap.mmap(self._file.fileno(), size, access=mmap.ACCESS_READ) if size else b""
        self._offsets, self._lengths = self._scan(verify)

    def _scan(self, verify: bool) -> tuple[np.ndarray, np.ndarray]:
        lib = native.load()
        if lib is not None:
            import ctypes

            cap = 1 << 16
            while True:
                offsets = np.zeros(cap, np.int64)
                lengths = np.zeros(cap, np.int64)
                n = lib.twin_scan_tfrecord(
                    self.path.encode(),
                    offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    cap,
                    1 if verify else 0,
                )
                if n < 0:
                    raise IOError(f"corrupt TFRecord {self.path} at byte {-n - 1}")
                if n <= cap:
                    return offsets[:n], lengths[:n]
                cap = int(n)
        # Pure-Python scan.
        offsets, lengths = [], []
        pos, size = 0, len(self._mm)
        while pos < size:
            if pos + 12 > size:
                raise IOError(f"corrupt TFRecord {self.path} at byte {pos}")
            (length,) = struct.unpack_from("<Q", self._mm, pos)
            (len_crc,) = struct.unpack_from("<I", self._mm, pos + 8)
            if masked_crc32c(self._mm[pos : pos + 8]) != len_crc:
                raise IOError(f"corrupt TFRecord {self.path} at byte {pos}")
            payload_off = pos + 12
            if payload_off + length + 4 > size:
                # Framing check independent of verify: a shard truncated
                # mid-payload (crashed converter) must not index a record
                # whose bytes are missing — mmap slices would silently clamp.
                raise IOError(
                    f"truncated TFRecord {self.path}: record at byte {pos} "
                    f"claims {length} payload bytes past EOF")
            if verify:
                payload = self._mm[payload_off : payload_off + length]
                (data_crc,) = struct.unpack_from("<I", self._mm, payload_off + length)
                if masked_crc32c(payload) != data_crc:
                    raise IOError(f"corrupt TFRecord {self.path} at byte {pos}")
            offsets.append(payload_off)
            lengths.append(length)
            pos = payload_off + length + 4
        return np.asarray(offsets, np.int64), np.asarray(lengths, np.int64)

    def __len__(self) -> int:
        return len(self._offsets)

    def __getitem__(self, idx: int) -> memoryview:
        off = int(self._offsets[idx])
        ln = int(self._lengths[idx])
        return memoryview(self._mm)[off : off + ln]

    def __iter__(self) -> Iterator[memoryview]:
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        if isinstance(self._mm, mmap.mmap):
            self._mm.close()
        self._file.close()


def list_shards(dataset_dir: str, split: str) -> list[str]:
    """All tfrecord shard files for a split, sorted (reference file_pattern
    '%s_%s_*.tfrecord' % (dataset_name, split)).

    The split must match as a '_'-delimited token (a dataset named
    'pretrain_faces' must not match split='train') and the name must end in
    '.tfrecord' (skips converter temp files like '*.tfrecord.tmp').
    """
    out = []
    for name in sorted(os.listdir(dataset_dir)):
        if not name.endswith(".tfrecord"):
            continue
        stem = name[: -len(".tfrecord")]
        if split in stem.split("_") or stem == split:
            out.append(os.path.join(dataset_dir, name))
    return out
