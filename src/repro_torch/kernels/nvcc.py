"""Build and load the port's CUDA kernels, and count their launches.

Every ``.cu`` file in ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together), linked into
one shared library with a plain C interface, and loaded with ``ctypes``.
The build happens at the first launch, never at import, into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the sources and flags so a changed
source rebuilds.  Rounding rules: ``-fmad=false`` and no
``--use_fast_math`` (see ``csrc/datapath.cuh``).

A build that runs ``nvcc`` counts as one compile event for
``repro_torch.obs.CompileTracker``.

Each kernel wrapper calls :func:`count_launch` right where it launches
its kernel, and nowhere else; :func:`launch_counts` and
:func:`reset_launches` let a caller show that a path went through the
kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..obs.compile import record_compile

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points and their argument types (every pointer and the stream
#: as c_void_p, so ctypes never truncates them to 32-bit ints)
SIGNATURES = {
    "rayflex_raybox": [_P] * 8 + [_I, _P],
    "rayflex_raytri": [_P] * 9 + [_I, _P],
    "rayflex_traverse": [_P, _I, _I, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P,
                         _P, _P, _P, _P, _P, _P],
    "rayflex_distance": [_P, _P, _P, _I, _I, _I, _I, _P],
    "rayflex_norm": [_P, _P, _I, _I, _I, _P],
    "rayflex_neighbor": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                         _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "rayflex_unified": [_P] * 4 + [_I, _P],
}

_launches: Counter = Counter()
_lib: ctypes.CDLL | None = None
#: each C entry point, bound once when the library loads, and the name its
#: launches count under
_entries: dict[str, tuple[ctypes._CFuncPtr, str]] = {}
#: what ptxas said about each kernel (registers, spills), kept for the
#: caller that built the library to print
build_log: dict[str, str] = {}


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launches() -> None:
    _launches.clear()


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this version is not built yet; return the
    path of the shared library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"librayflex_{_digest()}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        def compile_one(src: Path) -> Path:
            obj = Path(tmp) / (src.stem + ".o")
            proc = subprocess.run(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                 str(src), "-o", str(obj)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            build_log[src.name] = proc.stderr.strip()
            return obj

        srcs = _sources()
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            objs = list(pool.map(compile_one, srcs))
        staged = Path(tmp) / out.name
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
                               *map(str, objs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(staged, out)
    record_compile()
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[name] = fn, name.removeprefix("rayflex_")
        lib.rayflex_error_string.argtypes = [ctypes.c_int]
        lib.rayflex_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current CUDA stream, count
    the launch, and raise if it returned a CUDA error.

    ``device`` is the one the kernel's operands live on (each wrapper
    passes its first operand's, and :func:`check_cuda` holds every other
    operand to it).  The entry points launch on the current device, so a
    device other than the current one is entered for the call, and only
    then.  The entry point is bound once (:func:`library`), and the stream
    is read as a raw handle: the handle
    ``torch.cuda.current_stream().cuda_stream`` gives, without the
    ``Stream`` object it builds a call (0.5 against 6.9 us on the H100
    machine's host)."""
    entry = _entries.get(name)
    if entry is None:
        library()
        entry = _entries[name]
    fn, counted = entry
    current = torch._C._cuda_getDevice()
    if device.index in (None, current):
        err = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(device.index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        msg = _lib.rayflex_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
    count_launch(counted)


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: tuple, device: torch.device | None = None) -> int:
    """Validate one kernel operand (on ``device``, where given: the other
    operands' device); returns its data pointer."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, the kernel's other operands on "
                         f"{device}: one launch runs on one device")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()
