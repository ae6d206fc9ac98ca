"""Kernel B1: fused multi-step mean-field particle stepper.

``meanfield_multi_step`` advances k mean-field τ-leap steps per replica.  On
CUDA tensors it launches the hand-written kernel
(``csrc/meanfield_multi_step.cu``, the port of the TPU kernel
``hydrolim_tpu/ops/pallas_stepper.py``); on CPU tensors it runs
``meanfield_multi_step_plain``, a loop of ``_step_meanfield_global``.

Layout: unpadded (B, n) int32 pos/σ/wind; ``interop`` converts the TPU
kernel's (B, ⌈n/128⌉, 128) lanes.  Randomness is either injected
(``noise``: (B, k, n) uint32 bits held in int32, mapped to uniforms as
``(bits & 0xFFFFFF)·2⁻²⁴`` like the TPU kernel) or native: the kernel draws
Philox4x32-10 with key (seed, replica) and counter (particle group,
``step0`` + step), so advancing ``step0`` by k per call gives every call an
independent stream; the plain version draws from ``generator``.

Launch plan (``launch_plan``, a pure function tested on the CPU): a
thread-block cluster of C ≤ 8 CTAs per replica, the state packed on chip (in
registers or shared memory) where it fits, and calls split where the packed
winding change could overflow.  C is chosen so that all B clusters are
co-resident on the card (``cudaOccupancyMaxActiveClusters``) and, among
those, as the smallest that brings a CTA down to ``ONE_PASS_GROUPS``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Mapping, Optional, Tuple

import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu_torch.ops._build import check_cuda, load_kernel_library, ptr
from hydrolim_tpu_torch.particles.stepper import (
    ParticleState,
    _step_meanfield_global,
)

SOURCE = "hydrolim_tpu_torch/csrc/meanfield_multi_step.cu"
REPLACES = "hydrolim_tpu/ops/pallas_stepper.py:120"

MAX_THREADS = 1024
MAX_CLUSTER = 8                 # the portable cluster size
SMEM_LIMIT = 232_448            # bytes of shared memory one block may use
SLOT_BYTES = 2 * MAX_CLUSTER * 32 * 8   # the kernel's static reduction slots
REG_GROUPS_PER_THREAD = (1, 2, 4)       # the register-mode instantiations
MAX_POS = 1 << 16               # packed pos: 16 bits
MAX_DWIND = (1 << 13) - 1       # packed winding change: 14 signed bits
_MODES = {"registers": 0, "shared": 1, "global": 2}
# The groups per CTA below which a step stops getting faster: one group a
# thread in half a block's warps, where the step's fixed cost (m, two expf,
# the exchange of Σσ) and one dependent pass dominate.  PERF.md's cluster
# table (profile_meanfield_kernel.py --clusters) shows it at the main
# path's shape: 1250 groups per CTA at C=1, 625 at C=2, 417 at C=3 and
# 157-250 at C=5-8 take 2.19, 1.36, 1.22 and 1.27-1.29 µs per step.
ONE_PASS_GROUPS = 512


@dataclasses.dataclass(frozen=True)
class CtaShape:
    """One CTA's share of a replica at cluster size ``cluster``."""

    cluster: int
    mode: str              # 'registers', 'shared' or 'global'
    groups_per_thread: int  # registers: P (compile time); else the passes
    threads: int
    groups_per_cta: int

    @property
    def smem_bytes(self) -> int:
        return 16 * self.groups_per_cta if self.mode == "shared" else 0


@dataclasses.dataclass(frozen=True)
class B1Plan:
    shape: CtaShape
    steps_per_launch: int
    waves: int             # ⌈B / co-resident clusters⌉ (1: all at once)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cta_shape(n: int, L: int, cluster: int,
              mode: Optional[str] = None) -> CtaShape:
    """The state mode and thread count of one CTA when ``cluster`` CTAs
    share a replica of n particles (Philox groups of 4): registers where
    they hold the state, else shared memory, else device memory.  ``mode``
    forces a mode the state fits (to compare modes at one shape)."""
    gc = _cdiv(_cdiv(n, 4), cluster)
    packable = L <= MAX_POS
    fits = {"registers": packable
            and _cdiv(gc, REG_GROUPS_PER_THREAD[-1]) <= MAX_THREADS,
            "shared": packable and 16 * gc + SLOT_BYTES <= SMEM_LIMIT,
            "global": True}
    if mode is None:
        mode = next(m for m in ("registers", "shared", "global") if fits[m])
    elif not fits.get(mode, False):
        raise ValueError(f"meanfield_multi_step: the {mode!r} state does "
                         f"not hold {gc} groups per CTA at L={L}")
    if mode == "registers":
        P = next(P for P in REG_GROUPS_PER_THREAD
                 if _cdiv(gc, P) <= MAX_THREADS)
        return CtaShape(cluster, mode, P, 32 * _cdiv(_cdiv(gc, P), 32), gc)
    # the fewest thread-slots over all passes (ties: more threads, fewer
    # passes), so the last pass is as full as a multiple of 32 allows
    threads = min(range(32, MAX_THREADS + 1, 32),
                  key=lambda t: (_cdiv(gc, t) * t, -t))
    return CtaShape(cluster, mode, _cdiv(gc, threads), threads, gc)


def max_steps_per_launch(L: int) -> int:
    """The longest call whose packed winding change |Δwind| ≤ ⌈k/L⌉ + 1
    fits 14 signed bits."""
    return (MAX_DWIND - 1) * L


def launch_plan(B: int, n: int, L: int, k_steps: int,
                coresident: Mapping[int, int], cluster: Optional[int] = None,
                mode: Optional[str] = None) -> B1Plan:
    """The plan of one call.  ``coresident[C]`` is how many clusters of
    C CTAs of ``cta_shape(n, L, C)`` the card holds at once (C absent or 0:
    the shape cannot launch).  Among the C ≤ 8 with the fewest waves
    (⌈B / co-resident clusters⌉: all B at once where any C allows it), the
    smallest C whose CTA holds at most ``ONE_PASS_GROUPS`` groups, else
    the C with the fewest groups per CTA.  ``cluster`` and ``mode`` force
    a cluster size and a state mode.  Where the state is packed, calls
    longer than ``max_steps_per_launch(L)`` are split."""
    sizes = [cluster] if cluster else range(1, MAX_CLUSTER + 1)
    seated = [(_cdiv(B, int(coresident[C])), cta_shape(n, L, C, mode))
              for C in sizes if int(coresident.get(C, 0)) > 0]
    if not seated:
        raise ValueError(f"meanfield_multi_step: no cluster size of "
                         f"{list(sizes)} fits the card (n={n}, L={L})")
    waves = min(w for w, _ in seated)
    shapes = [sh for w, sh in seated if w == waves]
    small = [sh for sh in shapes if sh.groups_per_cta <= ONE_PASS_GROUPS]
    shape = (small[0] if small
             else min(shapes, key=lambda sh: sh.groups_per_cta))
    k_max = k_steps if shape.mode == "global" else max_steps_per_launch(L)
    return B1Plan(shape, max(1, min(k_steps, k_max)), waves)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """The TPU kernels' bits→uniform map on int32-held uint32 bits."""
    return (bits.to(torch.int64) & 0xFFFFFF).to(torch.float32) * 2.0 ** -24


def meanfield_multi_step_plain(scalars: torch.Tensor, seeds: torch.Tensor,
                               pos: torch.Tensor, sigma: torch.Tensor,
                               wind: torch.Tensor, *, L: int, k_steps: int,
                               dt: float, bidirectional: bool,
                               step0: int = 0,
                               noise: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: k steps of ``_step_meanfield_global``.
    ``seeds`` and ``step0`` select the kernel's native stream and are not
    used here; without ``noise`` the uniforms come from ``generator``."""
    B, n = pos.shape
    config = ParticleConfig(
        L=L, N=n, init="fixed", scale_rates=False, local_kernel_sigma=0.0,
        periodic=True, site_capacity=None,
        active_model="bidirectional" if bidirectional else "plus_forward")
    zero = torch.zeros_like(scalars[:, 0])
    params = ParticleParams(beta=scalars[:, 0], rate_diffusion=scalars[:, 1],
                            rate_active=scalars[:, 2], k_on=zero, k_off=zero,
                            k_exit=zero)
    state = ParticleState(pos=pos, sigma=sigma, wind=wind)
    for s in range(k_steps):
        u = bits_to_uniform(noise[:, s]) if noise is not None else None
        state = _step_meanfield_global(config, params, state, dt,
                                       u_override=u, generator=generator)
    return state.pos, state.sigma, state.wind


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _check_inputs(scalars, seeds, pos, sigma, wind, noise, k_steps,
                  step0) -> None:
    B, n = pos.shape
    dev = pos.device
    _check(scalars, "scalars", torch.float32, (B, 3), dev)
    _check(seeds, "seeds", torch.int32, (B,), dev)
    for name, t in (("pos", pos), ("sigma", sigma), ("wind", wind)):
        _check(t, name, torch.int32, (B, n), dev)
    if noise is not None:
        _check(noise, "noise", torch.int32, (B, k_steps, n), dev)
    if not (0 <= step0 and step0 + k_steps < 2 ** 31):
        raise ValueError(f"step0 out of range: {step0}")


def meanfield_multi_step(scalars: torch.Tensor, seeds: torch.Tensor,
                         pos: torch.Tensor, sigma: torch.Tensor,
                         wind: torch.Tensor, *, L: int, k_steps: int,
                         dt: float, bidirectional: bool, step0: int = 0,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """Advance k mean-field steps; returns new (pos, σ, wind).

    Args:
      scalars: (B, 3) float32 [β, rate_diffusion, rate_active] per replica
        (site units).
      seeds: (B,) int32 Philox seeds (native mode).
      pos/sigma/wind: (B, n) int32, pos in [0, L) and σ in {−1, 0, +1}; n
        is the true particle count and normalizes m.
      step0: global step index of the first step (native-mode counter).
      noise: optional (B, k_steps, n) int32 random bits.
      generator: the plain version's source of uniforms (CPU, no noise).
    """
    if pos.device.type == "cpu":
        return meanfield_multi_step_plain(
            scalars, seeds, pos, sigma, wind, L=L, k_steps=k_steps, dt=dt,
            bidirectional=bidirectional, step0=step0, noise=noise,
            generator=generator)
    if pos.device.type != "cuda":
        raise ValueError(f"meanfield_multi_step: unsupported device "
                         f"{pos.device}")
    B, n = pos.shape
    dev = pos.device
    plan = launch_plan(B, n, L, k_steps,
                       coresident_clusters(dev.index or 0, n, L))
    return meanfield_multi_step_planned(plan, scalars, seeds, pos, sigma,
                                        wind, L=L, k_steps=k_steps, dt=dt,
                                        bidirectional=bidirectional,
                                        step0=step0, noise=noise)


def _lib():
    lib = load_kernel_library("meanfield_multi_step")
    fn = lib.meanfield_multi_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.meanfield_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def coresident_clusters(device_index: int, n: int, L: int,
                        mode: Optional[str] = None) -> dict:
    """{C: clusters of ``cta_shape(n, L, C, mode)`` the card holds at
    once}, from ``cudaOccupancyMaxActiveClusters`` (0 where the shape
    cannot launch)."""
    lib = _lib()
    out = {}
    with torch.cuda.device(device_index):
        for C in range(1, MAX_CLUSTER + 1):
            try:
                sh = cta_shape(n, L, C, mode)
            except ValueError:      # a forced mode the state does not fit
                out[C] = 0
                continue
            cnt = ctypes.c_int(0)
            rc = lib.meanfield_max_active_clusters(
                _MODES[sh.mode], sh.groups_per_thread, C, sh.threads,
                sh.groups_per_cta, ctypes.byref(cnt))
            out[C] = cnt.value if rc == 0 else 0
    return out


def meanfield_multi_step_planned(plan: B1Plan, scalars, seeds, pos, sigma,
                                 wind, *, L: int, k_steps: int, dt: float,
                                 bidirectional: bool, step0: int = 0,
                                 noise: Optional[torch.Tensor] = None):
    """``meanfield_multi_step`` on CUDA tensors under a given plan (the
    wrapper's own, or one that ``launch_plan(..., cluster=C, mode=M)``
    forces, to compare cluster sizes and state modes): one launch per
    ``plan.steps_per_launch`` steps, ``step0`` advanced between them."""
    _check_inputs(scalars, seeds, pos, sigma, wind, noise, k_steps, step0)
    B, n = pos.shape
    sh = plan.shape
    if sh != cta_shape(n, L, sh.cluster, sh.mode):
        raise ValueError(f"meanfield_multi_step: a plan for {sh} does not "
                         f"fit n={n}, L={L}")
    fn = _lib().meanfield_multi_step_launch
    stream = ctypes.c_void_p(torch.cuda.current_stream(pos.device).cuda_stream)
    state = (pos, sigma, wind)
    s0 = 0
    while True:
        k = min(plan.steps_per_launch, k_steps - s0)
        out = tuple(torch.empty_like(t) for t in state)
        nz = (ctypes.c_void_p(noise.data_ptr() + 4 * s0 * n)
              if noise is not None else ctypes.c_void_p(0))
        meanfield_multi_step.launches += 1
        rc = fn(ptr(scalars), ptr(seeds), step0 + s0, *map(ptr, state),
                *map(ptr, out), nz, k_steps, B, n, L, k, dt,
                int(bidirectional), _MODES[sh.mode], sh.groups_per_thread,
                sh.cluster, sh.threads, sh.groups_per_cta, stream)
        check_cuda(rc, "meanfield_multi_step")
        state, s0 = out, s0 + k
        if s0 >= k_steps:
            return state


meanfield_multi_step.launches = 0
