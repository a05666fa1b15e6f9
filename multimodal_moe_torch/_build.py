"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so``, where the hash
covers the source and its compiler flags (``nvcc_flags``), so an edited
source rebuilds and an unchanged one loads from the cache. ``defines``
(``-D`` macros) give a second build of a source, for measurements. Sources have a
plain C interface (no
PyTorch headers), which keeps a build to seconds. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

# --fmad=false: no multiply-add contraction, so fp32 results match the plain
# PyTorch versions bit for bit (see csrc/nms_keep.cu). Never --use_fast_math.
# -Xptxas -v: ptxas reports each kernel's registers and spills (build_logs).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Sources built with other flags. The fused expert FFN sums products in an
# order no plain version shares, so it has nothing to gain from splitting
# every fp32 multiply-add in two.
SOURCE_FLAGS = {
    "moe_ffn_fwd": tuple(f for f in NVCC_FLAGS if f != "--fmad=false"),
}

_LOADED: "Dict[tuple, ctypes.CDLL]" = {}
build_seconds: "Dict[str, float]" = {}
build_logs: "Dict[str, str]" = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def nvcc_flags(name: str, defines: "tuple[str, ...]" = ()) -> "tuple[str, ...]":
    return SOURCE_FLAGS.get(name, NVCC_FLAGS) + tuple(f"-D{d}" for d in defines)


def build_key(name: str, defines: "tuple[str, ...]" = ()) -> str:
    """The name a build goes by in ``build_seconds`` and ``build_logs``."""
    return name if not defines else f"{name}[{','.join(defines)}]"


def library_path(name: str, defines: "tuple[str, ...]" = ()) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(nvcc_flags(name, defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, defines: "tuple[str, ...]" = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless the cached library is current."""
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # Compile to a private name, then rename: a concurrent loader never sees
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *nvcc_flags(name, defines), "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu ({proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, out)
        build_logs[build_key(name, defines)] = proc.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[build_key(name, defines)] = time.perf_counter() - t0
    return out


def load(name: str, defines: "tuple[str, ...]" = ()) -> ctypes.CDLL:
    """Build if needed, then load ``lib<name>``; cached per process."""
    key = (name, tuple(defines))
    if key not in _LOADED:
        _LOADED[key] = ctypes.CDLL(str(build(name, tuple(defines))))
    return _LOADED[key]
