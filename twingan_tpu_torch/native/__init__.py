"""The port's native (C++) host library, loaded with ctypes.

Counterpart of ``twingan_tpu/native``, with the JAX package's TFRecord
source copied as it is (``tfrecord.cc``: hardware CRC32C and the one-pass
record scan) and one more source, ``png_unfilter.cc`` (the PNG row
filters that ``data/png.py`` reverses). Both are compiled with g++ into one
library at first use:

    g++ -O3 -shared -fPIC [-msse4.2 on x86-64] tfrecord.cc png_unfilter.cc

into ``twingan_tpu_torch/_build/twindata-<hash>/libtwindata.so``, keyed by
a hash of the sources and the flags, as ``ops/cuda_build.py`` keys the
CUDA libraries (the JAX package builds next to its source). The compile
goes to a temporary file renamed into place. Without g++, or when the
build fails, ``load()`` returns None and every caller takes its
pure-Python path: a missing toolchain costs speed only, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("tfrecord.cc", "png_unfilter.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# SSE4.2 carries the CRC32C instruction; -march=native would tie the
# library to the CPU that built it.
FLAGS = ("-O3", "-shared", "-fPIC") + (
    ("-msse4.2",) if platform.machine() in ("x86_64", "AMD64") else ())

_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as fh:
            digest.update(name.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"twindata-{digest.hexdigest()[:16]}", "libtwindata.so")


def _build(out: str) -> bool:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=os.path.dirname(out))
    os.close(fd)
    cmd = ["g++", *FLAGS, *(os.path.join(_HERE, s) for s in SOURCES), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def load():
    """The ctypes library handle, or None if it cannot be built."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.twin_crc32c.restype = ctypes.c_uint32
        lib.twin_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.twin_masked_crc32c.restype = ctypes.c_uint32
        lib.twin_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.twin_scan_tfrecord.restype = ctypes.c_int64
        lib.twin_scan_tfrecord.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.twin_png_unfilter.restype = ctypes.c_int64
        lib.twin_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib
