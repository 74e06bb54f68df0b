"""The host commit's C++ passes, with numpy halves of identical semantics.

The card solves placement; committing that result back into cluster state
is host work: segment reductions over the snapshot tensors, result-code
decoding, run lengths and the status scatter of the apply phase.  Those
passes live in ``src/schedtpu.cpp`` (this package's own copy of the JAX
package's library, six ``extern "C"`` entry points), compiled into a shared
library and called through ctypes on numpy buffers.  Each entry point has a
numpy half with the same semantics, bit for bit.

Build: ``python -m scheduler_tpu_torch.native --build``, or at first use.
The library is compiled with ``$CXX`` (default ``g++``; ``-O3 -shared
-fPIC -std=c++17``) into ``build/scheduler_tpu_torch/`` beside the package,
named by a hash of the source, the compiler and the flags, as
``ops/cuda_build.py`` names the CUDA library.

``SCHEDULER_TORCH_NATIVE`` (default on, the twin of ``SCHEDULER_TPU_NATIVE``)
selects the library; ``0`` is the explicit numpy path.  With it on, a
library that does not build or load raises: nothing drops quietly to numpy.
The flag is read at every call, so one process can run both halves.

Result codes follow ``ops/fused.py``: >= 0 node, -1 unplaced, -2 failed,
<= -3 pipelined onto node ``-3 - code``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "schedtpu.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def enabled() -> bool:
    """``SCHEDULER_TORCH_NATIVE`` (default on)."""
    from scheduler_tpu_torch.utils.envflags import env_bool

    return env_bool("SCHEDULER_TORCH_NATIVE", True)


def _build_dir() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "build", "scheduler_tpu_torch")


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _lib_path() -> str:
    """Where the library of this source, compiler and flags lives."""
    h = hashlib.sha256(" ".join((_cxx(),) + CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_build_dir(), f"schedtpu-{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile the library if it is not there (or with ``force``); returns
    its path.  Raises when the compiler fails or cannot be run."""
    out = _lib_path()
    if os.path.exists(out) and not force:
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # Compile to a temporary name and rename: a concurrent process never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        cmd = [_cxx(), *CXX_FLAGS, _SRC, "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"native build failed: cannot run {cmd[0]!r}: {exc}") from exc
        if res.returncode != 0:
            raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                               f"{(res.stderr or res.stdout).strip()[:2000]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind_signatures(lib: ctypes.CDLL) -> None:
    """Declare every entry point's argument and result types."""
    i64 = ctypes.c_int64
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.segment_sum_f64.argtypes = [f64p, i32p, i64, i64, i64, f64p]
    lib.segment_sum_f64.restype = None
    lib.segment_sum_indexed_f64.argtypes = [f64p, i32p, i32p, i64, i64, i64, i64, f64p]
    lib.segment_sum_indexed_f64.restype = None
    lib.segment_count_i32.argtypes = [i32p, i64, i64, i32p]
    lib.segment_count_i32.restype = None
    lib.decode_placement_codes.argtypes = [i32p, i64, i32p, u8p, u8p]
    lib.decode_placement_codes.restype = i64
    lib.run_lengths_i32.argtypes = [f64p, f64p, i32p, i64, i64, i32p]
    lib.run_lengths_i32.restype = None
    lib.batch_status_scatter.argtypes = [i64, u64p, i64p, i64p, i16p, i16p, ctypes.c_int32]
    lib.batch_status_scatter.restype = i64


def _library() -> ctypes.CDLL:
    """The library, built and loaded once a process (raises on failure)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                _bind_signatures(lib)
                _lib = lib
    return _lib


def _load() -> Optional[ctypes.CDLL]:
    """The library when ``SCHEDULER_TORCH_NATIVE`` is on, else None."""
    return _library() if enabled() else None


def available() -> bool:
    """Whether the calls below run in the library (builds it if needed)."""
    return _load() is not None


def _as_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _as_f64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def segment_sum(rows: np.ndarray, seg: np.ndarray, num_segments: int) -> np.ndarray:
    """out[s] = sum of rows[i] where seg[i] == s; negative seg ids dropped."""
    rows = _as_f64(rows)
    seg = _as_i32(seg)
    t, r = rows.shape
    out = np.zeros((num_segments, r), dtype=np.float64)
    lib = _load()
    if lib is not None:
        lib.segment_sum_f64(rows, seg, t, r, num_segments, out)
    else:
        ok = (seg >= 0) & (seg < num_segments)
        np.add.at(out, seg[ok], rows[ok])
    return out


def segment_sum_indexed(
    matrix: np.ndarray, idx: np.ndarray, seg: np.ndarray, num_segments: int
) -> np.ndarray:
    """out[s] = sum of matrix[idx[i]] where seg[i] == s (gather + reduce);
    negative or out-of-range ids dropped."""
    matrix = _as_f64(matrix)
    idx = _as_i32(idx)
    seg = _as_i32(seg)
    n = idx.shape[0]
    t_total, r = matrix.shape
    out = np.zeros((num_segments, r), dtype=np.float64)
    lib = _load()
    if lib is not None:
        lib.segment_sum_indexed_f64(matrix, idx, seg, n, t_total, r, num_segments, out)
    else:
        ok = (idx >= 0) & (idx < t_total) & (seg >= 0) & (seg < num_segments)
        np.add.at(out, seg[ok], matrix[idx[ok]])
    return out


def segment_count(seg: np.ndarray, num_segments: int) -> np.ndarray:
    """counts[s] = rows with seg[i] == s (i32 [num_segments])."""
    seg = _as_i32(seg)
    lib = _load()
    if lib is not None:
        out = np.zeros(num_segments, dtype=np.int32)
        lib.segment_count_i32(seg, seg.shape[0], num_segments, out)
        return out
    ok = (seg >= 0) & (seg < num_segments)
    return np.bincount(seg[ok], minlength=num_segments).astype(np.int32)


def decode_placement_codes(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Split result codes into (node_id i32, pipelined bool, failed bool,
    n_placed)."""
    codes = _as_i32(codes)
    t = codes.shape[0]
    node_id = np.empty(t, dtype=np.int32)
    pipelined = np.empty(t, dtype=np.uint8)
    failed = np.empty(t, dtype=np.uint8)
    lib = _load()
    if lib is not None:
        placed = int(lib.decode_placement_codes(codes, t, node_id, pipelined, failed))
        return node_id, pipelined.view(bool), failed.view(bool), placed
    alloc = codes >= 0
    pipe = codes <= -3
    node_id[:] = np.where(alloc, codes, np.where(pipe, -3 - codes, -1))
    pipelined[:] = pipe
    failed[:] = codes == -2
    return node_id, pipelined.view(bool), failed.view(bool), int(alloc.sum() + pipe.sum())


def run_lengths(resreq: np.ndarray, init_resreq: np.ndarray, job_idx: np.ndarray) -> np.ndarray:
    """run[i] = count of consecutive rows from i with identical request rows
    (request and init request) within the same job."""
    resreq = _as_f64(resreq)
    init_resreq = _as_f64(init_resreq)
    job_idx = _as_i32(job_idx)
    t = resreq.shape[0]
    out = np.ones(t, dtype=np.int32)
    if t == 0:
        return out
    lib = _load()
    if lib is not None:
        lib.run_lengths_i32(resreq, init_resreq, job_idx, t, resreq.shape[1], out)
        return out
    # Group consecutive identical rows, then the distance to each group's
    # last row (no Python loop a row).
    same = (
        np.all(resreq[1:] == resreq[:-1], axis=1)
        & np.all(init_resreq[1:] == init_resreq[:-1], axis=1)
        & (job_idx[1:] == job_idx[:-1])
    )
    gid = np.concatenate(([0], np.cumsum(~same)))
    counts = np.bincount(gid)
    ends = np.cumsum(counts) - 1
    out[:] = (ends[gid] - np.arange(t) + 1).astype(np.int32)
    return out


def batch_status_scatter(
    status_arrays, rows_flat: np.ndarray, offsets: np.ndarray,
    from_vals: np.ndarray, to_vals: np.ndarray, check: bool,
) -> int:
    """Write group k's new status over rows ``rows_flat[offsets[k]:offsets[k+1]]``
    of ``status_arrays[k]`` (int16, C-contiguous).  Returns the first group
    whose prior values violated ``from_vals[k]`` when ``check`` (else -1)."""
    n = len(status_arrays)
    if n == 0:
        return -1
    rows_flat = np.ascontiguousarray(rows_flat, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    from_vals = np.ascontiguousarray(from_vals, dtype=np.int16)
    to_vals = np.ascontiguousarray(to_vals, dtype=np.int16)
    lib = _load()
    if lib is not None:
        for a in status_arrays:
            if a.dtype != np.int16 or not a.flags.c_contiguous:
                raise ValueError("batch_status_scatter: status columns must be C-contiguous "
                                 "int16")
        addrs = np.fromiter((a.ctypes.data for a in status_arrays), dtype=np.uint64, count=n)
        return int(lib.batch_status_scatter(n, addrs, rows_flat, offsets, from_vals, to_vals,
                                            1 if check else 0))
    bad = -1
    for k in range(n):
        rows = rows_flat[offsets[k]:offsets[k + 1]]
        st = status_arrays[k]
        if check and bad < 0 and not bool(np.all(st[rows] == from_vals[k])):
            bad = k
        st[rows] = to_vals[k]
    return bad
