"""Lattice-axis (spatial) parallelism for the site-centric engines.

The port of the JAX package's ``parallel/spatial.py``.  There a
``NamedSharding`` splits the lattice axis L over a 'space' mesh axis and
XLA lowers every ±1-site roll to a halo exchange and every global sum to
an all-reduce.  The port writes that by hand (``parallel.halo``):

- a mesh is a ``parallel.mesh.SweepMesh`` with the JAX axis names —
  ``space_mesh`` (1-D 'space') and ``grid_mesh`` (2-D ('sweep',
  'space')); a sharding (``space_sharding``, ``grid_sharding``) is a
  small frozen descriptor, the mesh and the axis the lattice rides;
- ``LatticeRun`` runs a slot engine's range runner (``LgRun``,
  ``LgkRun``) with segment j of the lattice on the mesh's device j: each
  step, every segment fetches its halo columns from its neighbours
  (``step_halo`` of them, the step's dependency radius), all-reduces the
  integer sums of global m, runs the unchanged step law on its window
  (``lg_step``/``lgk_step``'s window form) and keeps its own columns;
  the tracers read their movement flags from the segment that owns their
  site, exchanged as (B, n_t) values; once per frame the segments'
  columns are gathered and the frame is recorded on the gathered field;
- the draws are the one-device run's: one full-width draw per step on the
  controlling device, each segment taking its window's columns
  (``parallel.draws.ColumnTape``);
- on a ('sweep', 'space') grid, ``parallel.mesh.ShardedRun`` splits the
  batch over the rows and each row's block is a ``LatticeRun`` over that
  row's devices;
- ``PDEFields`` steps the PDE's (L,) fields by ``pde_step``, whole or
  split over a 'space' mesh (the large lattice's PDE half).

So a sharded slot-engine run equals the one-device run bit for bit —
every frame field (the variance and the spectrum too, recorded on the
gathered field) and the final state — and its carry is the one-device
run's, so a checkpointed run stopped on a mesh resumes without one.  An
explicit ``devices=[...]`` list may repeat a device (``["cpu"] * 8`` in
the tests, ``["cuda:0"] * 4`` in the card check): the copies are then
same-device copies, on the same code path.

Usage::

    mesh = space_mesh(devices=["cuda:0"] * 4)       # 1-D 'space' mesh
    frames, occ = run_lattice_gas(
        config, params, T=..., obs_dt=..., dt=...,
        occ_sharding=space_sharding(mesh))          # (B, L): L split 4-way
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hydrolim_tpu_torch.parallel.draws import column_streams
from hydrolim_tpu_torch.parallel.halo import HaloLayer, counters
from hydrolim_tpu_torch.parallel.mesh import (
    ShardedRun,
    SweepMesh,
    _as_devices,
    select_devices,
    shard_run,
    tree_map,
)
from hydrolim_tpu_torch.particles.lattice_gas import (
    global_m,
    run_frames,
    step_halo,
    window_band,
)
from hydrolim_tpu_torch.pde.stepper import pde_halo, pde_step, pde_update


def _on(tree, device):
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else x, tree)


def _object_array(devices) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return arr


def space_mesh(n_devices: Optional[int] = None, devices=None,
               axis_name: str = "space") -> SweepMesh:
    """1-D mesh over the lattice axis; device selection per
    ``parallel.mesh.select_devices`` (no virtual devices: more
    ``n_devices`` than the host has raises ``ValueError``; an explicit
    ``devices`` list may repeat a device)."""
    if devices is None:
        devices = select_devices(n_devices)
    devices = _as_devices(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return SweepMesh(_object_array(devices), (axis_name,))


@dataclasses.dataclass(frozen=True)
class LatticeSharding:
    """Where a lattice-trailing state lives: the lattice axis over the
    mesh's ``axis`` ('space'), the batch over 'sweep' on a grid mesh.
    ``spec`` is the JAX package's ``PartitionSpec`` as a tuple."""

    mesh: SweepMesh
    axis: str = "space"
    batched: bool = True
    slots: bool = False

    @property
    def grid(self) -> bool:
        return self.mesh.devices.ndim == 2

    @property
    def spec(self) -> tuple:
        lead = (("sweep",) if self.grid else
                ((None,) if self.batched else ()))
        return lead + ((None,) if self.slots else ()) + (self.axis,)


def space_sharding(mesh: SweepMesh, *, batched: bool = True,
                   slots: bool = False,
                   axis_name: str = "space") -> LatticeSharding:
    """Sharding for lattice-trailing state arrays on a 1-D mesh:

    - occupancy (B, L):      ``P(None, 'space')``        (batched=True)
    - slot field (B, K, L):  ``P(None, None, 'space')``  (slots=True)
    - unbatched (L,):        ``P('space')``
    """
    if mesh.devices.ndim != 1:
        raise ValueError("space_sharding takes a 1-D mesh (space_mesh); a "
                         "('sweep', 'space') grid takes grid_sharding")
    return LatticeSharding(mesh, axis_name, batched, slots)


def grid_mesh(n_sweep: int, n_space: int, devices=None) -> SweepMesh:
    """2-D ('sweep', 'space') mesh: replica-axis data parallelism composed
    with lattice-axis sharding.  Device order is row-major: the lattice
    segments of a row are adjacent devices, the rows stride."""
    n = n_sweep * n_space
    if devices is None:
        devices = select_devices(n)
    devices = _as_devices(devices)
    if len(devices) < n:
        raise ValueError(
            f"grid_mesh({n_sweep}, {n_space}) needs {n} devices, "
            f"have {len(devices)}")
    return SweepMesh(_object_array(devices[:n]).reshape(n_sweep, n_space),
                     ("sweep", "space"))


def grid_sharding(mesh: SweepMesh, *, slots: bool = False
                  ) -> LatticeSharding:
    """State sharding on a ``grid_mesh``: batch axis over 'sweep', lattice
    axis over 'space' — ``P('sweep', 'space')`` for (B, L) occupancy,
    ``P('sweep', None, 'space')`` for (B, K, L) slot fields.  Pass as
    ``occ_sharding=`` to the lattice-gas runners; trajectories and records
    are bit-identical to the unsharded run.  A batch that the rows do not
    divide is padded (``parallel.mesh.ShardedRun``)."""
    if mesh.devices.ndim != 2 or tuple(mesh.axis_names) != ("sweep",
                                                            "space"):
        raise ValueError("grid_sharding takes a ('sweep', 'space') "
                         "grid_mesh")
    return LatticeSharding(mesh, "space", True, slots)


# ---------------------------------------------------------------------------
# a range runner with its lattice split over a row of devices
# ---------------------------------------------------------------------------

class LatticeRun:
    """A slot engine's range runner (``LgRun``, ``LgkRun``) with its
    lattice split over ``devices`` (segment j on ``devices[j]``; ``ranks``
    the owning processes of a multi-process mesh).  It answers as ``run``
    does except ``run_range``, whose carry and records are the one-device
    run's, on ``run.device``, while every step runs segment by segment
    (``parallel.halo.HaloLayer``)."""

    def __init__(self, run, devices, ranks=None):
        self.run = run
        config = run.config
        devices = _as_devices(devices)
        kinds = {d.type for d in devices}
        if kinds != {run.device.type}:
            raise ValueError(f"the mesh's devices ({sorted(kinds)}) are not "
                             f"of the run's device type {run.device.type!r}")
        self.layer = HaloLayer(config.L, devices,
                               step_halo(run.band, config.periodic),
                               config.periodic, ranks)

        lay = self.layer
        self.params = {j: _on(run.params_b, lay.devices[j])
                       for j in lay.local}
        self.bands = {j: window_band(run.band, w.start, w.n, config.L,
                                     lay.devices[j])
                      for j, w in enumerate(lay.windows) if j in lay.local}

    def __getattr__(self, name):
        return getattr(self.__dict__["run"], name)

    def run_range(self, carry: dict, lo: int, hi: int):
        return run_frames(
            self.run, carry, lo, hi, advance=self._advance,
            split=self.layer.scatter,
            join=lambda parts: self.layer.gather(parts, self.run.device))

    def _advance(self, parts: dict, tr: dict, gen, inject):
        """One step of every local segment, and the tracers after it."""
        run, lay = self.run, self.layer
        with lay.stepping():
            wins = lay.exchange(parts)
            m = {j: None for j in lay.local}
            if run.band is None:
                sums = lay.all_reduce({j: run.seg_sums(parts[j])
                                       for j in lay.local})
                m = {j: global_m(sums[j]) for j in lay.local}
            streams = ({} if inject is not None else
                       column_streams(gen, run.device, lay))
            out, vals = {}, {}
            for j in lay.local:
                w = lay.windows[j]
                inj = (None if inject is None else
                       tuple(lay.take(x, j) for x in inject))
                new, flags = run.step(wins[j], self.params[j], self.bands[j],
                                      streams.get(j), inj, x0=w.start,
                                      m=m[j])
                out[j] = lay.interior(j, new)
                if run.n_t:
                    vals[j] = self._tracer_values(j, flags, tr)
            if streams:
                counters.draw_bytes += next(iter(
                    streams.values())).tape.bytes_drawn
            if run.n_t:
                total = lay.all_reduce(vals, device=run.device)
                tr = run.follow(tr, total.to(torch.int32).unbind(0))
        return out, tr

    def _tracer_values(self, j: int, flags, tr: dict) -> torch.Tensor:
        """Segment j's flags at the tracers on its sites, 0 at the others:
        (n_flags, B, n_t) on its device, int8 (movement flags and slot
        indices below K) where K < 128."""
        lay, w = self.layer, self.layer.windows[j]
        dev = lay.devices[j]
        tr_j = {k: v.to(dev) for k, v in tr.items()}
        site = tr_j["site"].long()
        own = (site >= w.x0) & (site < w.x1)
        col = torch.where(own, site - w.x0 + w.left, 0)
        got = self.run.tracer_values(flags, tr_j, col, w.n)
        small = torch.int8 if self.run.config.K < 128 else torch.int32
        return torch.stack([torch.where(own, v.to(small), 0) for v in got])


def sharded_run(run, params, *, mesh: Optional[SweepMesh] = None,
                occ_sharding: Optional[LatticeSharding] = None):
    """The range runner of ``run`` as the entry points take it: ``run``
    itself; over a sweep mesh (``mesh=``, ``parallel.mesh.ShardedRun``);
    or with the lattice over a 'space' mesh or a ('sweep', 'space') grid
    (``occ_sharding=``)."""
    if occ_sharding is None:
        return shard_run(mesh, run, params)
    if mesh is not None:
        raise ValueError("pass mesh= (the batch) or occ_sharding= (the "
                         "lattice, or a grid), not both")
    if not isinstance(occ_sharding, LatticeSharding):
        raise TypeError(f"occ_sharding must be a space_sharding or "
                        f"grid_sharding, not {type(occ_sharding).__name__}")
    slots = run.field == "slots"
    if occ_sharding.slots != slots or not occ_sharding.batched:
        raise ValueError(
            f"occ_sharding {occ_sharding.spec} does not fit the engine's "
            f"batched {'(B, K, L) slot' if slots else '(B, L) occupancy'} "
            "field (space_sharding(mesh, slots=...))")
    sh = occ_sharding
    if not sh.grid:
        return LatticeRun(run, list(sh.mesh.devices), sh.mesh.ranks)
    if sh.mesh.ranks is not None:
        raise ValueError("a ('sweep', 'space') grid runs in one process")
    rows = sh.mesh.devices
    return ShardedRun(sh.mesh, run, params, block_run=lambda i, p, d, b0:
                      LatticeRun(run.for_rows(p, d, b0), list(rows[i])))


# ---------------------------------------------------------------------------
# the PDE's fields, whole or split over a 'space' mesh
# ---------------------------------------------------------------------------

class PDEFields:
    """The PDE's (L,) fields ρ± stepped by ``pde.stepper.pde_step``: whole
    on their device (``mesh=None``), or split over a 'space' mesh, where
    each segment runs ``pde_update`` on its window (``pde_halo`` halo
    columns) and keeps its own columns, and the renormalization's masses
    are all-reduced.  Those float32 sums reassociate (segment by segment),
    so a split run is the whole run's to float32 roundoff, not bit for
    bit.  ``sum`` and ``mean`` reduce a per-site quantity
    ``fn(ops, rho_p, rho_m)`` over the lattice (all-reduced when split);
    ``fields`` returns ρ± whole, on the device they came on."""

    def __init__(self, config, params, ops, rho_p: torch.Tensor,
                 rho_m: torch.Tensor, mesh: Optional[SweepMesh] = None):
        self.config, self.device = config, rho_p.device
        self.layer = None
        if mesh is None:
            self.params, self.ops, self.p, self.m = params, ops, rho_p, rho_m
            return
        lay = self.layer = HaloLayer(config.L, list(mesh.devices),
                                     pde_halo(config, ops), True, mesh.ranks)
        self.params = {j: _on(params, lay.devices[j]) for j in lay.local}
        self.ops = {j: _on(ops, lay.devices[j]) for j in lay.local}
        self.p, self.m = lay.scatter(rho_p), lay.scatter(rho_m)

    def step(self) -> None:
        config, lay = self.config, self.layer
        if lay is None:
            self.p, self.m = pde_step(config, self.params, self.ops, self.p,
                                      self.m)
            return
        with lay.stepping():
            win_p, win_m = lay.exchange(self.p), lay.exchange(self.m)
            out, M0, M1 = {}, {}, {}
            for j in lay.local:
                rho_p1, rho_m1, rho_p2, rho_m2 = (
                    lay.interior(j, x) for x in pde_update(
                        config, self.params[j], self.ops[j], win_p[j],
                        win_m[j]))
                M0[j] = (rho_p1 + rho_m1).sum(-1, keepdim=True)
                M1[j] = (rho_p2 + rho_m2).sum(-1, keepdim=True)
                out[j] = (rho_p2, rho_m2)
            M0, M1 = lay.all_reduce(M0), lay.all_reduce(M1)
            for j in lay.local:
                scale = M0[j] / torch.clamp(M1[j], min=1e-30)
                self.p[j], self.m[j] = out[j][0] * scale, out[j][1] * scale

    def sum(self, fn) -> torch.Tensor:
        if self.layer is None:
            return fn(self.ops, self.p, self.m).sum()
        return self.layer.all_reduce(
            {j: fn(self.ops[j], self.p[j], self.m[j]).sum()
             for j in self.layer.local}, self.device)

    def mean(self, fn) -> torch.Tensor:
        if self.layer is None:
            return fn(self.ops, self.p, self.m).mean()
        return self.sum(fn) / self.config.L

    def fields(self):
        if self.layer is None:
            return self.p, self.m
        return (self.layer.gather(self.p, self.device),
                self.layer.gather(self.m, self.device))
