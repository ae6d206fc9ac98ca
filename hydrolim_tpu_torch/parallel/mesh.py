"""Replica-axis parallelism for sweeps and large ensembles.

The port of the JAX package's ``parallel/mesh.py``.  The sweep axes (β, σ,
N × replicas) are one flattened batch; a sweep mesh splits it into equal
blocks, block i running on device i — pure data parallelism, no
communication while stepping.  The JAX package declares this with
``NamedSharding`` and one program; here one controlling process drives an
ordered list of ``torch.device``s (``SweepMesh``), and ``ShardedRun`` runs
an engine's range runner block by block:

- the initial state, the kernels' Philox seeds and every per-step draw are
  made once for the real batch B on the controlling device, in the
  one-device order, then padded to the mesh multiple by repeating the last
  row (``pad_batch``) and sliced to the blocks (``shard_batch``,
  ``parallel.draws``);
- kernels B1, B2 and B3 key their Philox streams on the replica's global
  index (the launch's ``b0`` plus its row), so a block draws what the whole
  batch's launch draws for its rows;
- the blocks advance in lockstep, one frame (or snapshot block) at a time,
  and their records and carry are gathered back onto the controlling
  device (``gather_batch``), so a checkpoint's carry never depends on the
  mesh and a run stopped on 8 blocks resumes on 1.

What is bitwise: every draw and every integer state on every route, and
the float state and records wherever no sum depends on a block's row
count — which is why B2's plain dense solve (on the CPU) and the PDE's
final record row run one replica at a time.  The CPU tests hold every
route so; ``chip_smoke.py`` holds the kernels' routes on the card.

Which routes can gain wall time from more cards: one controlling thread
issues every block's work in turn.  On the kernel routes (B1, B2, B3) a
block's frame is one kernel launch and the card does the work, so blocks
on different cards run at once.  The plain-torch engines (the τ-leap
step, the slot engines, the torch fast path, the plain versions) are
host-bound — every step issues 100–200 small launches — so N blocks cost
the host N times those launches, and more cards cannot cut their wall
time under this design (``ROADMAP.md`` §A: worker threads per device, and
the multi-card measurement).

No device is faked: ``n_devices`` beyond the host's cards raises.  An
explicit ``devices=[...]`` list may repeat a device (the port's
counterpart of the JAX package's virtual CPU devices): the tests run
``["cpu"] * 8`` and the card check ``["cuda:0", "cuda:0"]``.

A 2-D mesh (``make_mesh``'s ('sweep', 'part'), ``parallel.spatial.
grid_mesh``'s ('sweep', 'space')) splits the batch over its rows, as the
JAX package's ``shard_batch`` puts the batch on its first axis.  The
sweep drivers keep the particle axis whole, as the JAX package's do, so
a row's block runs on the row's first device (``SweepMesh.record`` says
so); ``shard_particle_state`` places a particle state with the JAX
package's ('sweep', 'part') spec rule and ``gather_particle_state``
brings it back.  The lattice axis over 'space' is
``parallel.spatial``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hydrolim_tpu_torch.parallel.draws import shard_streams


@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """An ordered grid of ``torch.device``s with the JAX axis names:
    ``devices`` is an object array of shape (n_sweep,) or (n_sweep,
    n_part).  ``ranks`` is the process that owns each block of the sweep
    axis (None: this process owns every block; ``parallel.distributed.
    global_sweep_mesh`` sets it)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("sweep",)
    ranks: Optional[Tuple[int, ...]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def sweep_devices(self) -> List[torch.device]:
        """The device of each block of the sweep axis: on a 2-D mesh the
        first device of each row."""
        rows = self.devices.reshape(self.devices.shape[0], -1)
        return list(rows[:, 0])

    def is_local(self, i: int) -> bool:
        """True where block i runs in this process."""
        from hydrolim_tpu_torch.parallel.distributed import process_index

        return self.ranks is None or self.ranks[i] == process_index()

    def record(self) -> List[dict]:
        """Every block's device (and owning process), for a driver's JSON.
        On a 2-D mesh a block is a row: its first device runs the batch
        block, and the row's devices are listed under the second axis's
        name ('part': the particle axis stays whole on the row's first
        device; 'space': the row's lattice segments)."""
        if self.devices.ndim == 1:
            return [dict(block=i, device=str(d),
                         **({} if self.ranks is None else
                            dict(process=self.ranks[i])))
                    for i, d in enumerate(self.devices)]
        return [dict(block=i, device=str(row[0]),
                     **{self.axis_names[1]: [str(d) for d in row]})
                for i, row in enumerate(self.devices)]


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a·b = n."""
    best = (n, 1)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


def _as_devices(devices) -> List[torch.device]:
    return [torch.device(d) for d in devices]


def select_devices(n_devices: Optional[int] = None,
                   device_type: Optional[str] = None) -> List[torch.device]:
    """The host's devices of ``device_type`` (default: the cards if there
    are any, else the CPU): every card, or the one CPU.  Unlike the JAX
    package there is no fallback to virtual devices: asking for more
    ``n_devices`` than there are raises ``ValueError``."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(device_type)]
    if n_devices is not None and n_devices > len(devices):
        raise ValueError(
            f"n_devices={n_devices} but this host has {len(devices)} "
            f"{device_type} device(s); the port fakes no devices — pass "
            "mesh=sweep_mesh(devices=[...]) (a device may repeat) to split "
            "the batch over fewer")
    return devices


def _take(devices, n_devices: Optional[int]) -> List[torch.device]:
    devices = _as_devices(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    return devices


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("sweep", "part"),
              devices=None) -> SweepMesh:
    """2-D mesh over the devices (most-square factorization); device
    selection per :func:`select_devices`.  A sweep driver given it splits
    the batch over the first axis and runs each row's block on the row's
    first device; ``shard_particle_state`` places a state on both axes."""
    devices = _take(select_devices(n_devices) if devices is None else devices,
                    n_devices)
    a, b = _factor2(len(devices))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return SweepMesh(arr.reshape(a, b), tuple(axis_names))


def sweep_mesh(n_devices: Optional[int] = None, devices=None) -> SweepMesh:
    """1-D all-``'sweep'`` mesh — pure sweep-grid data parallelism, the
    default of the sweep drivers: the flattened (β × replicas) batch splits
    over every device, and no particle or lattice axis is split."""
    devices = _take(select_devices(n_devices) if devices is None else devices,
                    n_devices)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return SweepMesh(arr, ("sweep",))


def resolve_sweep_mesh(mesh: Optional[SweepMesh], n_devices: Optional[int],
                       device=None) -> Optional[SweepMesh]:
    """Driver-kwarg plumbing: an explicit mesh wins; else ``n_devices`` > 1
    builds a 1-D sweep mesh over the first ``n_devices`` of the host's
    devices of ``device``'s type (``select_devices``); else no sharding
    (None).  A mesh whose devices are not of ``device``'s type raises."""
    if mesh is None and n_devices is not None and n_devices > 1:
        mesh = sweep_mesh(n_devices, select_devices(
            n_devices, None if device is None else torch.device(device).type))
    if mesh is not None and device is not None:
        want = torch.device(device).type
        kinds = {torch.device(d).type for d in mesh.devices.reshape(-1)}
        if kinds != {want}:
            raise ValueError(f"the mesh's devices ({sorted(kinds)}) are not "
                             f"of the run's device type {want!r}")
    return mesh


def sweep_axis_size(mesh: Optional[SweepMesh]) -> int:
    if mesh is None:
        return 1
    return int(mesh.shape.get(mesh.axis_names[0], 1))


# ---------------------------------------------------------------------------
# batch trees: tensors and arrays in dicts, tuples, NamedTuples, dataclasses
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, trees of the
    same structure): dicts, lists, tuples, NamedTuples and dataclass
    instances are walked; anything else is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree, *rest)


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _pad_rows(x, Bp: int):
    n = x.shape[0]
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(Bp - n, *x.shape[1:])])
    return np.concatenate([x, np.repeat(x[-1:], Bp - n, axis=0)])


def pad_batch(tree, Bp: int, B: Optional[int] = None):
    """Pad every leading-batch-axis leaf to ``Bp`` rows by repeating the
    last row; the caller drops the pad replicas after the run.  With ``B``
    given, ONLY leaves whose leading dim equals ``B`` are batch leaves — a
    leaf with another short leading axis (per-field constants, anchor
    lists) passes through untouched.

    The JAX package pads its keys and draws at Bp, which its threefry
    streams allow (prefix-stable in the batch).  A torch generator is not
    prefix-stable, so the port draws at the real B and pads the draws
    (``parallel.draws``): the real replicas of the padded run are then the
    one-device run's, bit for bit."""

    def pad(x):
        if not _is_array(x) or x.ndim == 0 or x.shape[0] >= Bp:
            return x
        if B is not None and x.shape[0] != B:
            return x
        return _pad_rows(x, Bp)

    return tree_map(pad, tree)


def _local_blocks(mesh: SweepMesh) -> List[int]:
    return [i for i in range(sweep_axis_size(mesh)) if mesh.is_local(i)]


def shard_batch(mesh: SweepMesh, tree, B: Optional[int] = None
                ) -> Dict[int, object]:
    """Block i of every leading-batch-axis leaf (rows [i·n, (i+1)·n) of
    its ``B`` = n·(blocks) rows) onto the mesh's device i; other tensors
    are copied to every device, other leaves passed through.  Returns
    {block: tree} for the blocks this process runs.  ``B`` identifies the
    batch length (default: the first array leaf's dim 0)."""
    devices = mesh.sweep_devices()
    if B is None:
        leaves = []
        tree_map(lambda x: leaves.append(x) if _is_array(x) else None, tree)
        B = leaves[0].shape[0]
    n = len(devices)
    if B % n:
        raise ValueError(f"batch {B} is not a multiple of the mesh's "
                         f"{n} blocks (pad_batch first)")
    per = B // n

    def block(i):
        lo, dev = i * per, devices[i]

        def put(x):
            if _is_array(x) and x.ndim >= 1 and x.shape[0] == B:
                x = x[lo:lo + per]
            return x.to(dev) if isinstance(x, torch.Tensor) else x

        return tree_map(put, tree)

    return {i: block(i) for i in _local_blocks(mesh)}


def take_rows(tree, B: int):
    """The first ``B`` rows of every batch leaf (tensors and arrays that
    lead with at least ``B`` rows): the real replicas of a padded
    result."""
    return tree_map(lambda x: x[:B] if _is_array(x) and x.ndim
                    and x.shape[0] >= B else x, tree)


def pad_and_shard(mesh: Optional[SweepMesh], tree, B: int):
    """``pad_batch`` to the sweep-axis multiple, then ``shard_batch``;
    returns ``(blocks, Bp)``.  No-op ``(tree, B)`` when mesh is None."""
    if mesh is None:
        return tree, B
    n_sw = sweep_axis_size(mesh)
    Bp = -(-B // n_sw) * n_sw
    return shard_batch(mesh, pad_batch(tree, Bp, B=B), Bp), Bp


def gather_batch(mesh: SweepMesh, blocks: Dict[int, object], B: int,
                 device):
    """Undo ``pad_and_shard``: every block's batch leaves (tensors),
    concatenated in block order on ``device`` and cut to the real ``B``
    rows; the first block's other leaves.  Under a multi-process mesh
    the blocks of every process are gathered first, so every process
    returns the whole batch."""
    device = torch.device(device)
    if len(blocks) < sweep_axis_size(mesh):
        blocks = _all_gather_blocks(blocks)
    order = [blocks[i] for i in sorted(blocks)]

    def cat(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat([x.to(device) for x in xs])[:B]
        if isinstance(xs[0], np.ndarray):
            return np.concatenate(xs)[:B]
        return xs[0]

    return tree_map(cat, *order)


def _all_gather_blocks(blocks: Dict[int, object]) -> Dict[int, object]:
    """Every process's blocks, as CPU tensors, on every process."""
    import torch.distributed as dist

    host = {i: tree_map(lambda x: x.detach().cpu()
                        if isinstance(x, torch.Tensor) else x, t)
            for i, t in blocks.items()}
    parts: List[Optional[dict]] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, host)
    out = {}
    for part in parts:
        out.update(part)
    return out


class Spec:
    """A leaf's placement: the JAX ``PartitionSpec``'s axis name (or None)
    for each leading dimension; ``tuple(spec)`` gives them."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = axes

    def __iter__(self):
        return iter(self.axes)

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __repr__(self):
        return f"Spec{self.axes!r}"


@dataclasses.dataclass
class PlacedState:
    """A state placed on a 2-D mesh: ``blocks[(i, j)]`` is its tree on
    ``mesh.devices[i, j]``, ``specs`` the tree of each leaf's ``Spec``."""

    mesh: SweepMesh
    specs: object
    blocks: Dict[Tuple[int, int], object]


def _part_spec(x, sweep: str, part: str, batched: bool) -> Spec:
    """The JAX package's rule (``parallel/mesh.py:179-197``)."""
    if not _is_array(x):
        return Spec()
    if not batched:
        return Spec(part) if x.ndim >= 1 and x.shape[0] > 16 else Spec()
    if x.ndim >= 2 and x.shape[1] > 16:              # (B, n_buf, ...)
        return Spec(sweep, part)
    return Spec(sweep) if x.ndim >= 1 else Spec()


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what}: {n} is not a multiple of the mesh axis's "
                         f"{parts} devices")
    return n // parts


def shard_particle_state(mesh: SweepMesh, state, batched: bool = True
                         ) -> PlacedState:
    """Place a (batched) particle state on a 2-D mesh with the JAX
    package's spec rule: (B, n_buf, ...) leaves split over ('sweep',
    'part'), other per-replica leaves over 'sweep' only, an unbatched
    buffer over 'part'; the rest is copied to every device.  Placement
    never changes a value (``gather_particle_state`` brings the state
    back).  No engine steps a state split on 'part', as none in the JAX
    package does: the sweep drivers keep the particle axis whole."""
    if mesh.devices.ndim != 2:
        raise ValueError("shard_particle_state takes a 2-D mesh (make_mesh)")
    sweep, part = mesh.axis_names[:2]
    n_sw, n_pt = mesh.devices.shape
    specs = tree_map(lambda x: _part_spec(x, sweep, part, batched), state)

    def block(i, j):
        dev = mesh.devices[i, j]

        def put(x, spec):
            if not _is_array(x):
                return x
            x = torch.as_tensor(x)
            for d, ax in enumerate(spec):
                k, n = (i, n_sw) if ax == sweep else (j, n_pt)
                per = _split(x.shape[d], n, f"axis {d} over {ax!r}")
                x = x.narrow(d, k * per, per)
            return x.to(dev)

        return tree_map(put, state, specs)

    return PlacedState(mesh, specs, {(i, j): block(i, j)
                                     for i in range(n_sw)
                                     for j in range(n_pt)})


def gather_particle_state(placed: PlacedState, device):
    """The state of ``shard_particle_state`` back on ``device``, whole."""
    mesh = placed.mesh
    sweep, part = mesh.axis_names[:2]
    n_sw, n_pt = mesh.devices.shape
    blocks = [placed.blocks[(i, j)] for i in range(n_sw)
              for j in range(n_pt)]

    def join(spec, *xs):
        if not isinstance(xs[0], torch.Tensor):
            return xs[0]
        grid = [[xs[i * n_pt + j].to(device) for j in range(n_pt)]
                for i in range(n_sw)]
        axes = tuple(spec)
        rows = [torch.cat(r, axes.index(part)) if part in axes else r[0]
                for r in grid]
        return torch.cat(rows, axes.index(sweep)) if sweep in axes \
            else rows[0]

    return tree_map(join, placed.specs, *blocks)


# ---------------------------------------------------------------------------
# a range runner over a mesh
# ---------------------------------------------------------------------------

class ShardedRun:
    """An engine's range runner (``ParticleRun``, ``LgRun``, ``LgkRun``,
    ``AnchoredRun``, ``FusedRun``, ``PDERun``) with its batch split over a
    mesh.  It answers as ``run`` does (``start``, ``n_frames``,
    ``finish``, ...) except ``run_range``, whose carry and records are the
    one-device run's — the real batch B on ``run.device`` — while the
    work runs in blocks: block i is ``run.for_rows(params_i, device_i,
    b0=i·n)``, the carry's rows are padded, sliced to the blocks and
    gathered back after the range, and the blocks advance one unit
    (frame or snapshot block) at a time in lockstep, each drawing its rows
    of the one-device draws (``parallel.draws``).  Every tensor of a carry
    leads with the batch axis; its generator stays on ``run.device``.
    ``block_run(i, params_i, device_i, b0)`` makes block i's runner
    (default ``run.for_rows``; a ('sweep', 'space') grid splits each
    block's lattice over its row, ``parallel.spatial``)."""

    def __init__(self, mesh: SweepMesh, run, params, block_run=None):
        self.run, self.mesh = run, mesh
        devices = mesh.sweep_devices()
        kinds = {d.type for d in devices}
        if kinds != {run.device.type}:
            raise ValueError(f"the mesh's devices ({sorted(kinds)}) are not "
                             f"of the run's device type {run.device.type!r}")
        self.B = int(torch.as_tensor(params.beta).reshape(-1).shape[0])
        blocks, self.Bp = pad_and_shard(mesh, params, self.B)
        per = self.Bp // len(devices)
        self.bounds = {i: (i * per, (i + 1) * per) for i in blocks}
        block_run = block_run or (lambda i, p, dev, b0: run.for_rows(
            p, dev, b0=b0))
        self.runs = {i: block_run(i, blocks[i], devices[i], lo)
                     for i, (lo, _) in self.bounds.items()}
        self.devices = devices

    def __getattr__(self, name):
        return getattr(self.__dict__["run"], name)

    def run_range(self, carry: dict, lo: int, hi: int):
        B, Bp = self.B, self.Bp
        gens = [k for k, v in carry.items() if isinstance(v, torch.Generator)]
        if len(gens) > 1:
            raise ValueError(f"a carry with generators {gens}: one is "
                             "sharded")
        streams = shard_streams(carry[gens[0]] if gens else None, B, Bp,
                                self.bounds)
        blocks = {}
        for i, (a, b) in self.bounds.items():
            dev = self.devices[i]
            blk = {}
            for k, v in carry.items():
                if isinstance(v, torch.Tensor):
                    if v.shape[0] != B:
                        raise ValueError(f"carry {k!r} leads with "
                                         f"{v.shape[0]} rows, not the batch "
                                         f"{B}")
                    v = (_pad_rows(v, Bp) if Bp > B else v)[a:b].to(dev)
                elif isinstance(v, torch.Generator):
                    v = streams[i]
                blk[k] = v
            blocks[i] = blk
        records = {i: [] for i in self.bounds}
        for u in range(lo, hi):
            for i in self.bounds:
                rec, blocks[i] = self.runs[i].run_range(blocks[i], u, u + 1)
                records[i].append(rec)
        cat_units = lambda *xs: (torch.cat(xs, dim=1)
                                 if isinstance(xs[0], torch.Tensor) else xs[0])
        stacked = {i: tree_map(cat_units, *recs)
                   for i, recs in records.items()}
        out_records = gather_batch(self.mesh, stacked, B, self.run.device)
        out_carry = gather_batch(
            self.mesh, {i: {k: v for k, v in blk.items() if k not in gens}
                        for i, blk in blocks.items()}, B, self.run.device)
        # the tape drew from the run's generator as the one-device run does
        out_carry.update({k: carry[k] for k in gens})
        return out_records, dict((k, out_carry[k]) for k in carry)


def shard_run(mesh: Optional[SweepMesh], run, params):
    """``run`` itself without a mesh, else ``ShardedRun(mesh, run,
    params)``."""
    return run if mesh is None else ShardedRun(mesh, run, params)

