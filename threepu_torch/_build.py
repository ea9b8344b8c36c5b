"""Build and bind the CUDA kernels in ``threepu_torch/csrc``.

All ``csrc/*.cu`` sources compile, at first use, into one shared library
with a plain C interface: one nvcc per source, all started together,
then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xcompiler -fPIC -c -o <obj>/<name>.o csrc/<name>.cu    # each source
    nvcc -shared -o _build/libthreepu_kernels_<hash>.so <obj>/*.o

``-fmad=false`` keeps every product and sum separately rounded, as the
plain PyTorch versions compute them, so the kernels can match those
bit for bit.  The library name carries a hash of the sources and flags:
editing any source builds a new library.  The library is loaded with
``ctypes``; each C entry point takes device pointers, ints and a CUDA
stream, and returns the ``cudaError_t`` of its launch, which
:class:`Kernel` turns into an exception.  Nothing here runs at import
time: this module imports on machines without a GPU or ``nvcc``.
:func:`build` also makes variants for diagnostics (some sources, with
extra ``-D`` defines) under names of their own; :func:`library` loads
only the full one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_library: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("threepu_torch: nvcc not found on PATH or in "
                           f"{home}/bin; the CUDA kernels cannot be built")
    return path


def _sources(stems: Optional[Sequence[str]] = None) -> list:
    """The ``.cu`` files, all or those named by ``stems``."""
    return [src for src in sorted(CSRC_DIR.glob("*.cu"))
            if stems is None or src.stem in stems]


def _flags(defines: Sequence[str]) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(stems: Optional[Sequence[str]] = None,
                 defines: Sequence[str] = ()) -> Path:
    """Where the library of the current sources lives (built or not): of
    every ``.cu`` file, or of those named by ``stems``, with ``defines``."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for path in sorted(CSRC_DIR.glob("*.cuh")) + _sources(stems):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libthreepu_kernels_{h.hexdigest()[:16]}.so"


def build(ptxas_verbose: bool = False,
          stems: Optional[Sequence[str]] = None,
          defines: Sequence[str] = ()) -> Path:
    """Compile the library unless the current sources are built already.

    Returns its path.  With ``ptxas_verbose`` the compiler's report of
    registers, shared memory and spills per kernel is printed.  ``stems``
    (source names without ``.cu``) and ``defines`` (each passed as
    ``-D``) build a variant of the library under a name of its own.
    """
    out = library_path(stems, defines)
    if out.exists():
        return out
    nvcc = nvcc_path()
    obj_dir = BUILD_DIR / f"{out.stem}.{os.getpid()}.obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    verbose = ["-Xptxas=-v"] if ptxas_verbose else []
    t0 = time.perf_counter()
    jobs = []
    for src in _sources(stems):
        cmd = [nvcc, *_flags(defines), *verbose, "-c", "-o",
               str(obj_dir / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           text=True)))
    results = []
    for cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        results.append((cmd, proc.returncode, stdout, stderr))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp),
            *(str(obj_dir / f"{src.stem}.o") for src in _sources(stems))]
    if all(rc == 0 for _, rc, _, _ in results):
        res = subprocess.run(link, capture_output=True, text=True)
        results.append((link, res.returncode, res.stdout, res.stderr))
    shutil.rmtree(obj_dir, ignore_errors=True)
    for cmd, rc, stdout, stderr in results:
        if rc != 0:
            raise RuntimeError(f"threepu_torch: nvcc failed ({rc}):\n"
                               f"{' '.join(cmd)}\n{stdout}{stderr}")
        if ptxas_verbose:
            print(stderr, end="", flush=True)
    os.replace(tmp, out)
    print(f"threepu_torch: built {out.name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        lib.threepu_error_string.argtypes = [ctypes.c_int]
        lib.threepu_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


class Kernel:
    """One C entry point of the kernel library and its launch count.

    ``argtypes`` lists the ctypes of the arguments before the stream
    (``c_void_p`` for device pointers, ``c_int`` for ints); calls pass
    ``tensor.data_ptr()`` for pointers.  Each call launches on PyTorch's
    current stream, raises if the launch was refused (the C function
    returned a ``cudaError_t`` other than 0), and only then adds one to
    :attr:`launches`.  A call inside a CUDA graph's capture launches
    nothing: :class:`threepu_torch.models.graphs.Stages` adds a graph's
    captured launches to :attr:`launches` at each replay instead.
    :attr:`instances` lists every entry point made.
    """

    instances: List["Kernel"] = []

    def __init__(self, symbol: str, argtypes: Sequence, source: str,
                 replaces: str):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.source = source          # the CUDA file, relative to the repo
        self.replaces = replaces      # the Pallas kernel it ports, file:line
        self.launches = 0
        self._fn = None
        Kernel.instances.append(self)

    def __call__(self, *args) -> None:
        lib = library()
        if self._fn is None:
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = lib.threepu_error_string(err).decode(errors="replace")
            raise RuntimeError(f"threepu_torch: {self.symbol} launch failed "
                               f"with cudaError_t {err}: {msg}")
        self.launches += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    rank ``ndim`` — what a kernel of this library takes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
