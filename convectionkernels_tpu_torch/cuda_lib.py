"""Build and load the hand-written CUDA kernels of csrc/.

Each source compiles on its own with nvcc into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ctypes. A library is built at first use into build/torch_kernels/
of the checkout, under a name keyed by a hash of its source, the shared
header and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. `build_all` starts one nvcc per source, all at once.

Exactness flags: the encoder is held byte for byte against its reference,
so the kernels are compiled without FMA contraction, with IEEE divide and
sqrt, and with subnormals kept — the semantics of eager PyTorch on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

SOURCES = ("shape_pca", "single_plane", "dual_plane", "bc6h_group",
           "exact_probe")
HEADERS = ("bc7_common.cuh",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",     # registers, stack and spills, kept in log_path()
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry point, argument types, of each library
SIGNATURES = {
    "shape_pca": ("ck_shape_pca",
                  [_P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P]),
    "single_plane": ("ck_single_plane_mode_best",
                     [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _P, _P, _P, _P, _P, _P]),
    "dual_plane": ("ck_dual_plane_best",
                   [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                    _P, _P, _P]),
    "bc6h_group": ("ck_bc6h_group",
                   [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                    _P, _P, _P]),
    "exact_probe": ("ck_exact_probe", [_P, _P, _I, _P, _P, _P]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for fname in (f"{name}.cu",) + HEADERS:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    """nvcc's output (ptxas resource usage) for the library of `name`."""
    return library_path(name)[:-len(".so")] + ".log"


def _start_build(name: str):
    """Start nvcc for `name` unless its library exists; returns
    (process, temp path, final path) or None."""
    path = library_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def _finish_build(name: str, started) -> None:
    proc, tmp, path = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    with open(log_path(name), "w") as f:
        f.write(out)
    os.replace(tmp, path)


def build_all(names=SOURCES) -> None:
    """Build every library that is missing, one nvcc per source, all
    started together."""
    with _lock:
        started = {n: _start_build(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is None:
                continue
            try:
                _finish_build(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def function(name: str):
    """The C entry point of library `name`, built and loaded on first use."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    build_all((name,))
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(library_path(name))
            sym, argtypes = SIGNATURES[name]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
