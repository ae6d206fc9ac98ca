"""ctypes binding and build-at-first-use of the native Gillespie oracle.

A copy of the JAX package's ``runtime/native.py`` for the port (which must
not import that package).  ``gillespie.cpp`` beside this file samples the
particle generator exactly, one event at a time; it is a host-side test
oracle for the τ-leap engine, not an engine of the card.  The shared
library is compiled with g++ into ``hydrolim_tpu_torch/_build/``, under a
name that carries the source's hash (an edited source is rebuilt), and
moved into place atomically (concurrent test processes may build at once).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "gillespie.cpp"
_BUILD = _HERE.parent / "_build"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha1(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD / f"libgillespie_{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    c_ll = ctypes.c_longlong
    c_d = ctypes.c_double
    c_i = ctypes.c_int
    lib.run_gillespie.restype = c_ll
    lib.run_gillespie.argtypes = [
        c_ll, c_ll, c_d, c_d, c_d, c_d, c_d, c_ll,          # L..K
        c_i, c_i, c_i, c_i, c_i, c_d, c_d, c_d,             # flags + k_on..
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        c_d, c_d, ctypes.c_ulonglong,                        # T, obs_dt, seed
        c_ll,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return lib


def run_exact_gillespie(config, params, pos0, sigma0, *, T: float,
                        obs_dt: float, seed: int = 0) -> Dict:
    """Run the exact CTMC with the same generator as the τ-leap step.

    ``config``/``params`` are the port's ``ParticleConfig`` and
    ``ParticleParams`` (scalar tensors; rates already ``scale_rates``
    resolved); ``pos0``/``sigma0`` the initial particle arrays.  Returns
    per-frame counts, m_global and alive counts, and the event count."""
    lib = load_library()
    L = config.L
    pos0 = np.ascontiguousarray(np.asarray(pos0, np.int64))
    sigma0 = np.ascontiguousarray(np.asarray(sigma0, np.int8))
    N = pos0.shape[0]
    anchor = np.ascontiguousarray(config.anchor_mask().astype(np.uint8))
    times = np.arange(0.0, T, obs_dt)
    M = len(times)
    cp = np.zeros((M, L), np.int64)
    cm = np.zeros((M, L), np.int64)
    mg = np.zeros((M,), np.float64)
    na = np.zeros((M,), np.int64)

    g = lambda v: float(np.asarray(v.cpu() if hasattr(v, "cpu") else v))
    events = lib.run_gillespie(
        L, N, config.dx, g(params.rate_diffusion), g(params.rate_active),
        g(params.beta), config.local_kernel_sigma,
        config.site_capacity if config.exclusion else 0,
        int(config.periodic),
        int(config.active_model == "bidirectional"),
        int(config.immobilize_when_anchored),
        int(config.suppress_flip_when_bound),
        int(config.crowding_suppresses_rates),
        g(params.k_on), g(params.k_off), g(params.k_exit),
        pos0, sigma0, anchor, float(T), float(obs_dt), int(seed) & (2**64 - 1),
        M, cp, cm, mg, na)
    if events < 0:
        raise RuntimeError("native gillespie rejected the initial state")
    return dict(times_obs=times, counts_p=cp, counts_m=cm, m_global=mg,
                n_alive=na, n_events=int(events))
