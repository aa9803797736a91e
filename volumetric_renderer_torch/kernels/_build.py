"""Builds a CUDA source of ``csrc/`` into a shared library with a plain C
interface (nvcc, loaded with ``ctypes``).

The library is compiled on first use into ``build/kernels/`` at the root of
the checkout, under a name keyed on a hash of the source, the shared
headers and the flags, so a changed source or header is rebuilt and an
unchanged one is loaded again.  Nothing is compiled at import time.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

# sm_90a: Hopper.  -fmad=false keeps every multiply and add separately
# rounded, as in the plain PyTorch versions; -Xptxas -v reports registers,
# shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    path: str        # the shared library
    log: str         # nvcc's output for this build (ptxas lines)
    seconds: float   # compile time, 0.0 when an earlier build was reused


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin "
                       "(default /usr/local/cuda/bin): the CUDA kernels "
                       "cannot be built")


def _source_key(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` header (the sources
    include them) and the flags: an edit to any of them means a rebuild."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            key.update(fname.encode() + b"\0" + f.read() + b"\0")
    return key.hexdigest()[:16]


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless an identical build exists; raise
    with nvcc's output if it fails."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    out = os.path.join(BUILD_DIR, f"{name}_{_source_key(name)}.so")
    log_path = out + ".log"
    if os.path.exists(out) and os.path.exists(log_path):
        with open(log_path) as f:
            return Built(out, f.read(), 0.0)

    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{src}:\n{log}")
    os.replace(tmp, out)
    with open(log_path, "w") as f:
        f.write(log)
    return Built(out, log, seconds)
