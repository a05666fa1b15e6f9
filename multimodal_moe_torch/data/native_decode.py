"""ctypes binding to the native JPEG decoder (``native/jpeg_loader``).

The port's own binding to ``native/jpeg_loader/jpeg_loader.cpp``, the
counterpart of ``multimodal_moe_tpu/data/native_decode.py``. The library is
built at first use with ``native/build.sh``'s flags (``g++ -O3
-march=native -fPIC -shared ... -ljpeg -lpthread``) into the port's own
build directory, ``multimodal_moe_torch/build/``, compiled to a private name
and renamed into place, so concurrent processes never see a half-written
library (and never share one with the JAX package's ``native/lib/``). Its
name carries a hash of the source, the flags and the host CPU, since
``-march=native`` code runs only on the CPU it was built for. It is rebuilt
when the source is newer, and refused unless ``mmoe_jpeg_version()``
matches.

Where g++ or libjpeg is missing, ``native_available()`` is False: RGB
decodes take PIL (as in JAX), the raw 4:2:0 plane functions cannot run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .._build import BUILD_DIR

_SRC_PATH = Path(__file__).resolve().parents[2] / "native" / "jpeg_loader" / "jpeg_loader.cpp"
_GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared")
_LINK_FLAGS = ("-ljpeg", "-lpthread")
# Must match mmoe_jpeg_version() in jpeg_loader.cpp.
_EXPECTED_VERSION = 12

_lib: "Optional[ctypes.CDLL]" = None
_load_attempted = False
_load_lock = threading.Lock()
build_error: "Optional[str]" = None  # why the last build failed, for skip reasons


def _host_cpu() -> str:
    """The host CPU's model and flags, which ``-march=native`` depends on."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.processor()
    keep = [ln for ln in text.splitlines() if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2])


def library_path() -> Path:
    key = (_SRC_PATH.read_bytes() + " ".join(_GXX_FLAGS + _LINK_FLAGS).encode()
           + platform.machine().encode() + _host_cpu().encode())
    return BUILD_DIR / f"libmmoe_jpeg-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile the decoder to a private name in the build directory, then
    rename it into place."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [gxx, *_GXX_FLAGS, "-o", tmp, str(_SRC_PATH), *_LINK_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()[-400:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mmoe_jpeg_version.restype = ctypes.c_int
    lib.mmoe_jpeg_version.argtypes = []
    lib.mmoe_decode_jpeg.restype = ctypes.c_int
    lib.mmoe_decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p, ctypes.c_int,
                                     ctypes.c_int]
    lib.mmoe_decode_files.restype = ctypes.c_int
    lib.mmoe_decode_files.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)]
    lib.mmoe_decode_jpeg_yuv420.restype = ctypes.c_int
    lib.mmoe_decode_jpeg_yuv420.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p, u8p, u8p,
                                            ctypes.c_int, ctypes.c_int]
    lib.mmoe_decode_files_yuv420.restype = ctypes.c_int
    lib.mmoe_decode_files_yuv420.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                             u8p, u8p, u8p, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.POINTER(ctypes.c_int)]


def load_library() -> "Optional[ctypes.CDLL]":
    """Load the decoder, building it first if it is missing or older than
    its source; None when it cannot be built or reports another version."""
    global _lib, _load_attempted, build_error
    with _load_lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            out = library_path()
            if not out.exists() or _SRC_PATH.stat().st_mtime > out.stat().st_mtime:
                _build(out)
            lib = ctypes.CDLL(str(out))
            _declare(lib)
            version = int(lib.mmoe_jpeg_version())
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        if version != _EXPECTED_VERSION:
            build_error = f"mmoe_jpeg_version() is {version}, not {_EXPECTED_VERSION}"
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _out_array(out: "Optional[np.ndarray]", shape: tuple) -> np.ndarray:
    if out is None:
        return np.empty(shape, np.uint8)
    if out.shape != shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {shape}, "
                         f"got {out.dtype} {out.shape}")
    return out


def decode_jpeg_bytes(data: bytes, out_h: int, out_w: int) -> np.ndarray:
    """Decode one JPEG byte string to (out_h, out_w, 3) uint8 (PIL where the
    native decoder is unavailable)."""
    lib = load_library()
    if lib is None:
        return _pil_decode_bytes(data, out_h, out_w)
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.mmoe_decode_jpeg(data, len(data), _u8(out), out_h, out_w)
    if rc != 0:
        raise ValueError(f"native JPEG decode failed (rc={rc})")
    return out


def decode_jpeg_files(
    paths: "Sequence[str | os.PathLike]",
    out_h: int,
    out_w: int,
    *,
    n_threads: Optional[int] = None,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Decode a batch of JPEG files to one (N, out_h, out_w, 3) uint8 array
    on the native thread pool (no GIL); PIL file by file without it."""
    n = len(paths)
    out = _out_array(out, (n, out_h, out_w, 3))
    lib = load_library()
    if lib is None:
        for i, p in enumerate(paths):
            out[i] = _pil_decode_bytes(Path(p).read_bytes(), out_h, out_w)
        return out
    if n_threads is None:
        n_threads = max(1, (os.cpu_count() or 1))
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    status = (ctypes.c_int * n)()
    failures = lib.mmoe_decode_files(c_paths, n, _u8(out), out_h, out_w, n_threads, status)
    if failures:
        bad = [str(paths[i]) for i in range(n) if status[i] != 0]
        raise ValueError(f"native JPEG decode failed for {len(bad)} files: {bad[:3]}")
    return out


def decode_jpeg_bytes_yuv420(data: bytes, h: int, w: int):
    """One 4:2:0 JPEG → (y (h,w), cb (h/2,w/2), cr (h/2,w/2)) uint8 planes.

    None when the decoder is unavailable or the stream is not 3-component
    2×2-subsampled at exactly (h, w)."""
    lib = load_library()
    if lib is None:
        return None
    y = np.empty((h, w), np.uint8)
    cb = np.empty((h // 2, w // 2), np.uint8)
    cr = np.empty((h // 2, w // 2), np.uint8)
    rc = lib.mmoe_decode_jpeg_yuv420(data, len(data), _u8(y), _u8(cb), _u8(cr), h, w)
    if rc == 3:
        return None
    if rc != 0:
        raise ValueError(f"native YUV420 decode failed (rc={rc})")
    return y, cb, cr


def decode_jpeg_files_yuv420(
    paths: "Sequence[str | os.PathLike]",
    h: int,
    w: int,
    *,
    n_threads: Optional[int] = None,
):
    """Batch of 4:2:0 JPEGs → (y (N,h,w), cb (N,h/2,w/2), cr (N,h/2,w/2)).

    Raises ValueError on any unsuitable or undecodable file, RuntimeError
    when the decoder is unavailable."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable ({build_error})")
    n = len(paths)
    y = np.empty((n, h, w), np.uint8)
    cb = np.empty((n, h // 2, w // 2), np.uint8)
    cr = np.empty((n, h // 2, w // 2), np.uint8)
    if n_threads is None:
        n_threads = max(1, (os.cpu_count() or 1))
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    status = (ctypes.c_int * n)()
    failures = lib.mmoe_decode_files_yuv420(c_paths, n, _u8(y), _u8(cb), _u8(cr), h, w,
                                            n_threads, status)
    if failures:
        bad = [str(paths[i]) for i in range(n) if status[i] != 0]
        raise ValueError(f"native YUV420 decode failed for {len(bad)} files: {bad[:3]}")
    return y, cb, cr


def _pil_decode_bytes(data: bytes, out_h: int, out_w: int) -> np.ndarray:
    import io

    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        img = img.convert("RGB")
        if img.size != (out_w, out_h):
            img = img.resize((out_w, out_h), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)
