"""Builds of the port's native sources, shared by every kernel wrapper.

Each source under `csrc/` compiles on its own into a shared library with a
plain C interface, named by a hash of the source and the flags, into
`_build/` at first use, and loads with ctypes:

* `*.cu` with nvcc (sm_90a, `--fmad=false`, IEEE division), each with
  the shared headers `csrc/*.cuh`;
* `*.cpp` (the host BVH builder) with the host `c++`, `-O3 -march=native`
  and, if that fails, `-O3` alone, as the JAX package builds its copy.

`build_all` starts one compiler per source at once and waits for all of
them, so a fresh checkout builds in the time of its slowest file. A
failed build raises. Nothing here runs when a module is imported.

`refuse_grad` is every wrapper's gate for autograd: a kernel has no
backward, so its outputs are constants, and a float input that requires
grad raises on the CPU (whose plain version autograd could differentiate)
as on the card, so that the two never disagree.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
HOST_FLAGS_PORTABLE = ("-O3", "-shared", "-fPIC")

_LIBS = {}          # source path -> (library path, ctypes.CDLL)


def refuse_grad(*xs):
    """Raise NotImplementedError where grad is enabled and a float input
    requires grad: no kernel has a backward."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in xs):
        raise NotImplementedError(
            "no gradient through the intersection kernels: an input that "
            "requires grad (a ray or the geometry) would get none")


def source(name: str) -> str:
    return os.path.join(CSRC, name)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _command(src: str, flags=None):
    if src.endswith(".cu"):
        return [_nvcc(), *NVCC_FLAGS]
    return ["c++", *(flags or HOST_FLAGS)]


def lib_path(src: str) -> str:
    """The library of `src`, named by a hash of the source, of the headers
    of csrc/ (for a .cu source) and of the compiler's flags."""
    parts = [src]
    if src.endswith(".cu"):
        parts += sorted(os.path.join(CSRC, h) for h in os.listdir(CSRC)
                        if h.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(_command(src)[1:]).encode())
    for path in parts:
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")


def _start(src: str, flags=None):
    """Start the compiler for `src` unless its library exists; returns
    (process, temporary output path) or None."""
    out = lib_path(src)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen([*_command(src, flags), "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(src: str, started) -> str:
    if started is None:
        return ""
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0 and src.endswith(".cpp"):
        # the host may not know -march=native: build portable code
        proc, tmp = _start(src, HOST_FLAGS_PORTABLE)
        log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"build failed on {src}:\n{log}")
    os.replace(tmp, lib_path(src))
    return log


def build_all(sources) -> dict:
    """Compile every source not built yet, all compilers at once, then
    load them. Returns {source: compiler output ('' if cached)}."""
    started = {src: _start(src) for src in sources}
    logs = {src: _finish(src, st) for src, st in started.items()}
    for src in sources:
        load(src)
    return logs


def load(src: str) -> ctypes.CDLL:
    """The loaded library of `src`, built first if needed."""
    path = lib_path(src)
    hit = _LIBS.get(src)
    if hit is not None and hit[0] == path:
        return hit[1]
    if not os.path.exists(path):
        _finish(src, _start(src))
    lib = ctypes.CDLL(path)
    _LIBS[src] = (path, lib)
    return lib


def bind(src: str, name: str, argtypes, restype=ctypes.c_int):
    """A C function of the library of `src`, typed. A kernel's launcher
    returns the CUDA error code of its launch (0 when accepted)."""
    fn = getattr(load(src), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
