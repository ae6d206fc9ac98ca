"""Build-at-first-use of the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``_build/lib<name>_<hash>.so`` (the hash covers
the sources, so an edited kernel is rebuilt) and loaded with ``ctypes``.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Flags of one kernel's build: kernel B2 rounds its products and sums one
# by one, as its plain version does (its fused multiply-adds are written
# out), so that its two routes compile one law.
KERNEL_FLAGS = {"pde_multi_step": ["--fmad=false"]}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources_digest(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS + KERNEL_FLAGS.get(name, []))
                     .encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def build_kernel_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists; returns
    the shared library's path.  The compiler's register/shared-memory report
    (``-Xptxas -v``) is kept beside it as ``<name>.ptxas.txt``."""
    so = BUILD_DIR / f"lib{name}_{_sources_digest(name)}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *KERNEL_FLAGS.get(name, []), "-o",
           str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, so)
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(
        f"# {' '.join(cmd)}\n# {time.perf_counter() - t0:.1f} s\n"
        + res.stderr)
    return so


@functools.lru_cache(maxsize=None)
def load_kernel_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_kernel_library(name)))


def check_cuda(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {rc})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)
