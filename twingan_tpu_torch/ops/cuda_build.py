"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is one ``csrc/*.cu`` file with a plain C interface (no
PyTorch headers), compiled at first use for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

into ``twingan_tpu_torch/_build/<name>-<hash>/``, keyed by a hash of the
source, of every header in ``csrc/`` (``*.cuh``, which a source may
include) and of the flags, so an edited source or header rebuilds and an
unchanged one is loaded as built. The compile goes to a temporary file that is renamed into
place, so two processes building at once cannot load a half-written
library. A failed build raises with nvcc's output; there is no other path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC_DIR), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when loaded as already built),
#          "log": nvcc's output (register and shared-memory use)}
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    home_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if nvcc is None and os.path.exists(home_nvcc):
        nvcc = home_nvcc
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels of "
            "twingan_tpu_torch are built at first use and need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built, keyed by its content, the headers
    of ``csrc/`` and the flags."""
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, source), "rb") as fh:
            digest.update(source.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}", f"lib{name}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        return out
    nvcc = find_nvcc()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=os.path.dirname(out))
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr}
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build(name))
        return lib
