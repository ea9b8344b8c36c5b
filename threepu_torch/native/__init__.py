"""Host-side C++ helpers bound with ctypes (the port's copy of
:mod:`threepu.native`): FPS, nearest-neighbour distances and a text
parser for ``.xyz`` files.  They run on the host CPU, not on the GPU.

``_native.cpp`` compiles at first use with ``g++`` into
``threepu_torch/_build/libthreepu_native_<hash>.so`` (the hash covers the
source and the flags, so an edit builds a new library):

    g++ -O3 -std=c++17 -ffp-contract=off -shared -fPIC _native.cpp -o ...

:func:`load` raises :class:`BuildError` with the compiler's message when
the library cannot be built, and every later call raises the same
without running ``g++`` again.  Callers that have a numpy version use
:func:`available`, which says once through the logger that they fall
back to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from threepu_torch.utils import logger

SOURCE = Path(__file__).resolve().parent / "_native.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_warned = False


class BuildError(OSError):
    """The native library could not be built (no ``g++``, or it failed)."""


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libthreepu_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile to a file of this process, then rename it into place: a
    parallel process never loads a library half written."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:                      # no g++ on PATH
        raise BuildError(f"threepu_torch.native: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"threepu_torch.native: g++ failed "
                         f"({res.returncode}):\n{' '.join(cmd)}\n"
                         f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The native library, built first if needed; raises
    :class:`BuildError` where it cannot be built."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise BuildError(_error)
        out = library_path()
        if not out.exists():
            try:
                _build(out)
            except BuildError as e:
                _error = str(e)
                raise
        lib = ctypes.CDLL(str(out))
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.fps_f32.argtypes = [f32p, i64, i64, i64, i32p]
        lib.fps_f32.restype = None
        lib.nn_dist2_f32.argtypes = [f32p, i64, f32p, i64, f32p, i32p,
                                     f32p, i32p]
        lib.nn_dist2_f32.restype = None
        lib.parse_floats.argtypes = [ctypes.c_char_p, i64, f32p, i64]
        lib.parse_floats.restype = i64
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library loads (it is built, or a library there loads);
    the first time it does not, says so through
    :func:`threepu_torch.utils.logger.warn` (numpy takes over)."""
    global _warned
    try:
        load()
        return True
    except OSError as e:
        if not _warned:
            _warned = True
            logger.warn(f"native host library unavailable, using numpy: {e}")
        return False


def fps_cpu(points: np.ndarray, m: int, seed: int = 0) -> np.ndarray:
    """``m`` FPS picks of ``points (N, >=3)`` on the host, int32 in pick
    order, starting at ``seed``: the semantics of
    :func:`threepu_torch.ops.fps.fps_plain` (carry 1e10, ties to the
    lowest index) with a chosen first point."""
    lib = load()
    points = np.ascontiguousarray(points[:, :3], np.float32)
    out = np.empty(m, np.int32)
    lib.fps_f32(points, points.shape[0], m, seed, out)
    return out


def nn_dist2_cpu(a: np.ndarray, b: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(dist_a, idx_a, dist_b, idx_b)``: squared nearest-neighbour
    distances from ``a (N, >=3)`` into ``b (M, >=3)`` and back, float32,
    int32 argmins (ties to the lowest index)."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        raise ValueError(f"empty point cloud: |a|={a.shape[0]} "
                         f"|b|={b.shape[0]}")
    lib = load()
    a = np.ascontiguousarray(a[:, :3], np.float32)
    b = np.ascontiguousarray(b[:, :3], np.float32)
    da, ia = np.empty(a.shape[0], np.float32), np.empty(a.shape[0], np.int32)
    db, ib = np.empty(b.shape[0], np.float32), np.empty(b.shape[0], np.int32)
    lib.nn_dist2_f32(a, a.shape[0], b, b.shape[0], da, ia, db, ib)
    return da, ia, db, ib


def chamfer_cpu(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared nearest-neighbour distance both ways, on the host."""
    da, _, db, _ = nn_dist2_cpu(a, b)
    return float(da.mean() + db.mean())


def parse_xyz(path: str, max_points: Optional[int] = None) -> np.ndarray:
    """The float32 rows of a plain numeric ``.xyz`` text file (3 or more
    columns, whitespace or commas), each value rounded once by ``strtof``.
    Raises ``ValueError`` for what it does not parse (a first line that is
    empty or a ``#`` comment, a value count that is not a multiple of the
    first line's), which ``np.loadtxt`` may."""
    lib = load()
    with open(path, "rb") as f:
        raw = f.read()
    first = raw.split(b"\n", 1)[0].split()
    if not first or any(t.startswith(b"#") for t in first):
        raise ValueError(f"{path}: no numeric first line")
    ncol = len(first)
    cap = len(raw) // 2 + ncol
    buf = np.empty(cap, np.float32)
    n = lib.parse_floats(raw, len(raw), buf, cap)
    if n % ncol:
        raise ValueError(f"{path}: {n} values do not fill rows of {ncol}")
    pts = buf[:n].reshape(-1, ncol)
    return pts if max_points is None else pts[:max_points]
