"""One build of every CUDA kernel of the port.

Every ``csrc/*.cu`` of the package is compiled with ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library under ``build/scheduler_tpu_torch/``,
named by a hash of all the sources and the flags, and loaded with
``ctypes``.  Each source has a plain C entry point (no PyTorch headers), so
a source compiles in seconds; the sources compile in parallel, one ``nvcc``
each, and one link makes the library.  The build runs at the first launch
of any kernel, on the machine with the card (``nvcc`` on ``PATH`` or under
``/usr/local/cuda/bin``); a later launch in the same process reuses it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_lib = None
build_info: dict = {}


def sources() -> list:
    return sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))


def _build_dir() -> str:
    return os.path.join(os.path.dirname(_PKG), "build", "scheduler_tpu_torch")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(srcs, flags=()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def load(verbose: bool = False) -> ctypes.CDLL:
    """The library of every kernel, built once per source hash.  With
    ``verbose`` the compiler reports each kernel's registers and spills
    (``-Xptxas -v``) into ``build_info["log"]``."""
    global _lib, build_info
    if _lib is not None:
        return _lib
    srcs = sources()
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"kernels-{_digest(srcs)}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        seconds, log = _compile(srcs, out_dir, path, verbose)
    _lib = ctypes.CDLL(path)
    build_info = {"path": path, "sources": [os.path.basename(s) for s in srcs],
                  "seconds": seconds, "log": log}
    return _lib


def load_variant(names, defines) -> ctypes.CDLL:
    """A separate library of the sources ``names`` (file names under
    ``csrc/``) built with the preprocessor ``defines`` (e.g. an instrumented
    build for a measurement script); the port's own library is untouched."""
    srcs = [os.path.join(_PKG, "csrc", name) for name in names]
    flags = tuple(f"-D{d}" for d in defines)
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"variant-{_digest(srcs, flags)}.so")
    if not os.path.exists(path):
        _compile(srcs, out_dir, path, False, flags)
    return ctypes.CDLL(path)


def _compile(srcs, out_dir, path, verbose, flags=()):
    """Compile every source to an object in parallel, then link them into
    ``path``.  Returns (seconds, compiler output)."""
    nvcc = _nvcc()
    extra = (("-Xptxas", "-v") if verbose else ()) + tuple(flags)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"{os.path.basename(src)}:\n{out.strip()}")
            if proc.returncode != 0:
                failed.append(src)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        so = os.path.join(tmp, "kernels.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(so, path)
    return time.perf_counter() - start, log
