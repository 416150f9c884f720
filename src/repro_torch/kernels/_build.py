"""Build and load the port's CUDA kernels, at first use.

The five sources in ``csrc/`` export a plain C interface (no PyTorch
headers), so ``nvcc`` builds them in seconds.  Each source compiles to
an object in its own ``nvcc`` process, all at once, and one more
``nvcc`` links them into a shared library under ``build/repro_torch/``
at the root of the checkout.  The file name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one
is loaded from there.  The library is bound with ``ctypes``: every
pointer and the stream are ``c_void_p``.  It is loaded as a ``PyDLL``,
which keeps the interpreter lock across a call: the launchers only
queue work and return at once, so releasing the lock would only add
host time to every launch.

Nothing here runs at import; ``library()`` builds on its first call and
raises, with ``nvcc``'s stderr, when the build fails.  Cluster workers
are threads that launch kernels, so the first call holds a lock (one
build, one binding, whichever thread comes first), and the wrappers
count their launches through ``count_launch``, exact under concurrent
launches.
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
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bcsr_matmul.cu", "cyclic_encode.cu", "decode_matmul.cu",
           "mla_decode.cu", "held_experts.cu")
HEADERS = ("common.cuh",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_SIGNATURES = {
    # a_data, a_dtype, a_idx, counts, b, b_dtype, b_worker_stride, rows, c,
    # n_out, mb, n_workers, J, K, N, device, stream
    "repro_bcsr_matmul": (_P, _I, _P, _P, _P, _I, _LL, _P, _P, _I, _I, _I,
                          _I, _I, _I, _I, _P),
    # blocks, dtype, block_stride, row_stride, sup, coef, out, k, T, C, n,
    # w, elems, device, stream
    "repro_cyclic_encode": (_P, _I, _LL, _LL, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _P),
    # hinv, y, rows, out, geometry (13 int64: see decode_matmul.cu), stream
    "repro_decode_matmul": (_P, _P, _P, _P, _P, _P),
    # q_hat, q_pe, c, kr, out, geometry (12 int64: see mla_decode.cu),
    # scale, stream
    "repro_mla_decode": (_P, _P, _P, _P, _P, _P, _F, _P),
    # x, w_gate, w_up, w_down, weights, key, order, ends, xs, h, y, out,
    # geometry (6 int64: see held_experts.cu), stream
    "repro_held_experts": (_P,) * 14,
}

_lib: ctypes.PyDLL | None = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
# how the library was obtained: {"seconds": build time, "cached": bool}
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's kernels are built with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(procs) -> None:
    errors = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def _compile(target: Path) -> None:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(str(obj))
        _run(procs)
        lib = Path(tmp) / target.name
        cmd = [nvcc, *FLAGS, "-shared", *objs, "-o", str(lib)]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(lib, target)      # atomic: a reader never sees half


def library() -> ctypes.PyDLL:
    """The loaded kernel library, built from ``csrc/`` if needed."""
    lib = _lib
    if lib is not None:
        return lib
    with _lib_lock:
        return _lib if _lib is not None else _load()


def _load() -> ctypes.PyDLL:
    global _lib
    target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    t0 = time.perf_counter()
    cached = target.exists()
    if not cached:
        _compile(target)
    lib = ctypes.PyDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(seconds=time.perf_counter() - t0, cached=cached,
                      path=str(target))
    _lib = lib
    return lib


def count_launch(fn, *also: str) -> None:
    """Add one to ``fn.launches`` (a wrapper's launch counter) and to each
    counter of ``fn`` named in ``also`` (a split of it); exact when
    several threads launch at once."""
    with _count_lock:
        fn.launches += 1
        for name in also:
            setattr(fn, name, getattr(fn, name) + 1)


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


# -- argument checks shared by the wrappers ---------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t, name: str) -> int:
    """The C interface's code for ``t``'s dtype, or for the dtype ``t``
    (f32 or bf16 only)."""
    dtype = t if isinstance(t, torch.dtype) else t.dtype
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {dtype} not supported by the "
                        f"kernel (float32 or bfloat16)")
    return code


def require(t, name: str, device, dtype=None) -> None:
    """``t`` must be a contiguous tensor on ``device`` (and of ``dtype``)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raw_stream(index: int) -> int:
    """PyTorch's current stream on CUDA device ``index``, as the launchers
    take it: read as a raw pointer, without building a
    ``torch.cuda.Stream`` object, which costs more host time than the
    launch."""
    return torch._C._cuda_getCurrentRawStream(index)


def stream_ptr(device) -> int:
    """``raw_stream`` of a ``torch.device`` (the current device when it
    names no index)."""
    index = device.index
    return raw_stream(torch.cuda.current_device() if index is None
                      else index)
