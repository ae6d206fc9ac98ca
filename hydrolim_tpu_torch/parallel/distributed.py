"""Multi-process initialization (the JAX package's
``parallel/distributed.py``).

One process drives the cards of its host (``parallel.mesh``).  For a run
over several processes call :func:`initialize_multihost` once per process
before any run; the sweep mesh of :func:`global_sweep_mesh` then spans
every process's devices.  The default layout is one process per card:
``initialize_multihost`` makes the process's card (``cuda:<local rank>``,
``LOCAL_RANK`` or the rank modulo the host's cards) current, which is
where NCCL runs its collectives, and ``global_sweep_mesh`` gives each
process that card alone.  A process that drives several cards passes
them as ``global_sweep_mesh(devices=[...])``.
Each process runs the blocks on its own devices and draws the same
one-device draws (every process seeds the same generator), and after each
range the runner gathers every block's records and carry onto every
process (``torch.distributed.all_gather_object``), so every process
returns the whole result.  :func:`is_primary` picks the process that
writes files.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from hydrolim_tpu_torch.parallel.mesh import SweepMesh, select_devices


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` over TCP at
    ``coordinator_address`` (``host:port``), with the JAX package's
    environment fallbacks (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID).  No-op when no address is given (a single-process
    run).  ``backend``: NCCL where the host has cards, else gloo; under
    NCCL the process's card (:func:`local_rank`) becomes current."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return
    # NB: `x or env` would drop the valid process_id 0 — test None explicitly
    if num_processes is None:
        num_processes = os.environ.get("JAX_NUM_PROCESSES", 1)
    if process_id is None:
        process_id = os.environ.get("JAX_PROCESS_ID", 0)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        card = local_rank(int(process_id))
        if card >= torch.cuda.device_count():
            raise ValueError(f"process {process_id} is local rank {card} but "
                             f"this host has {torch.cuda.device_count()} "
                             "card(s)")
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank(rank: Optional[int] = None) -> int:
    """This process's index among the processes of its host:
    ``LOCAL_RANK`` where the launcher sets it, else ``rank`` (default: this
    process's) modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_index() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def local_devices() -> List[torch.device]:
    """The devices whose blocks this process runs by default: in a
    multi-process run on cards its own card (the current one, which
    :func:`initialize_multihost` set); in a single-process run every card
    of the host; without cards the CPU."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    if process_count() > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return select_devices(device_type="cuda")


def global_sweep_mesh(axis_name: str = "sweep", devices=None) -> SweepMesh:
    """1-D mesh over every process's devices, process by process: this
    process's ``devices`` (default: :func:`local_devices`) are the blocks
    it runs.  Every process must bring as many devices.  Call
    :func:`initialize_multihost` first in multi-process runs."""
    local = [torch.device(d) for d in
             (local_devices() if devices is None else devices)]
    names = [str(d) for d in local]
    if process_count() > 1:
        every = [None] * process_count()
        dist.all_gather_object(every, names)
    else:
        every = [names]
    if len({len(e) for e in every}) != 1:
        raise ValueError(f"the processes bring different device counts: "
                         f"{[len(e) for e in every]}")
    flat = [torch.device(d) for e in every for d in e]
    arr = np.empty(len(flat), dtype=object)
    arr[:] = flat
    ranks = tuple(r for r, e in enumerate(every) for _ in e)
    return SweepMesh(arr, (axis_name,), ranks)


def is_primary() -> bool:
    """True on the process that should write checkpoints, npz files and
    figures."""
    return process_index() == 0
