"""The halo layer of a lattice split over a 'space' mesh axis.

In the JAX package a ``NamedSharding`` splits the lattice axis L over a
'space' mesh axis, and XLA's SPMD partitioner inserts the communication:
every ±1-site roll becomes a halo exchange between lattice neighbours
(collective-permute) and every global sum an all-reduce.  The port has no
partitioner, so this module is that communication, written by hand:

- ``segment_bounds``: segment j of S owns the sites [j·L/S, (j+1)·L/S);
  L must be a multiple of S, as ``NamedSharding`` requires;
- ``windows``: the columns a segment steps on — its own sites and ``h``
  halo columns on each side (the ring wraps on a torus; a wall ends the
  halo), which the step recomputes and then drops;
- ``HaloLayer``: ``exchange`` fetches each window's halo columns from the
  segments that own them, ``all_reduce`` adds per-segment sums,
  ``gather`` brings the segments' columns to one device (once per frame,
  for the records), ``take`` cuts a window's columns out of a full-width
  tensor (the one-device draws, ``parallel.draws.ColumnTape``).

In one process these are ``.to(device)`` copies of column slices.  Across
processes (a mesh of ``parallel.distributed.global_sweep_mesh``, whose
``ranks`` say which process owns each segment) the halo is
``torch.distributed`` isend/irecv, the sums ``all_reduce`` and the frame
``all_gather``: gloo on the CPU, NCCL on cards.

``counters`` records what the layer moved: the steps taken, the halo
copies and bytes, the all-reduces and their bytes, and the full-field
gathers made inside a step (never, by construction: a step moves halo
columns and sums only) and at frame ends.  A window wider than the
lattice (a dense smoothing band, whose every row reads every site) is
allowed: its columns repeat sites, each a copy of the same pre-step
value.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class HaloCounters:
    """What the halo layers moved since the last ``reset``."""

    steps: int = 0              # lattice steps (one per row of segments)
    halo_copies: int = 0        # column blocks fetched from another segment
    halo_bytes: int = 0
    allreduces: int = 0         # m sums and tracer flags
    allreduce_bytes: int = 0
    step_gathers: int = 0       # full-field gathers inside a step
    frame_gathers: int = 0      # full-field gathers at frame ends
    gather_bytes: int = 0
    scatter_bytes: int = 0      # a range's carry split onto the segments
    draw_bytes: int = 0         # full-width draws made for the segments

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


counters = HaloCounters()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def segment_bounds(L: int, S: int) -> List[Tuple[int, int]]:
    """Segment j owns the sites [j·L/S, (j+1)·L/S)."""
    if L % S:
        raise ValueError(f"L={L} is not a multiple of the 'space' axis's "
                         f"{S} segments")
    n = L // S
    return [(j * n, (j + 1) * n) for j in range(S)]


@dataclasses.dataclass(frozen=True)
class Window:
    """The columns segment ``seg`` steps on: ``left`` halo columns, its
    sites [x0, x1), ``right`` halo columns; column z is the global site
    ``start`` + z (mod L)."""

    seg: int
    x0: int
    x1: int
    left: int
    right: int
    start: int

    @property
    def n(self) -> int:
        return self.left + self.x1 - self.x0 + self.right

    def sites(self, L: int) -> np.ndarray:
        return (self.start + np.arange(self.n)) % L


def windows(L: int, S: int, h: int, periodic: bool) -> List[Window]:
    """Every segment's window with ``h`` halo columns on each side (fewer
    at a wall)."""
    out = []
    for j, (x0, x1) in enumerate(segment_bounds(L, S)):
        left = h if periodic else min(h, x0)
        right = h if periodic else min(h, L - x1)
        out.append(Window(j, x0, x1, left, right, (x0 - left) % L))
    return out


def _pieces(w: Window, L: int, seg_len: int) -> List[Tuple[int, int, int]]:
    """The window's columns as runs ``(owner, a, b)``: columns [a, b) of
    segment ``owner``, in window order."""
    out: List[list] = []
    for site in w.sites(L):
        owner, col = divmod(int(site), seg_len)
        if out and out[-1][0] == owner and out[-1][2] == col:
            out[-1][2] = col + 1
        else:
            out.append([owner, col, col + 1])
    return [tuple(p) for p in out]


class HaloLayer:
    """One row of segments: the lattice of ``L`` sites split over
    ``devices`` (segment j on ``devices[j]``), each stepping on a window
    with ``h`` halo columns.  ``ranks[j]`` is the process that owns
    segment j (None: this process owns all); ``local`` lists the segments
    this process runs.  Tensors lead with any batch axes; the lattice is
    the last."""

    def __init__(self, L: int, devices: Sequence, h: int, periodic: bool,
                 ranks: Optional[Sequence[int]] = None):
        from hydrolim_tpu_torch.parallel.distributed import process_index

        self.L, self.h, self.periodic = L, h, periodic
        self.devices = [torch.device(d) for d in devices]
        S = len(self.devices)
        self.bounds = segment_bounds(L, S)
        self.seg_len = L // S
        self.windows = windows(L, S, h, periodic)
        self.ranks = None if ranks is None else tuple(ranks)
        me = process_index()
        self.local = [j for j in range(S)
                      if self.ranks is None or self.ranks[j] == me]
        self.pieces = [_pieces(w, L, self.seg_len) for w in self.windows]
        self._cols: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        self._in_step = False

    # -- placement ----------------------------------------------------------

    def _is_local(self, j: int) -> bool:
        return self.ranks is None or j in self.local

    def cols(self, j: int, device) -> torch.Tensor:
        """Window j's global sites, int64 on ``device`` (cached)."""
        key = (j, torch.device(device))
        if key not in self._cols:
            self._cols[key] = torch.as_tensor(
                self.windows[j].sites(self.L), device=device)
        return self._cols[key]

    def take(self, x: torch.Tensor, j: int) -> torch.Tensor:
        """Window j's columns of the full-width ``x``, on segment j's
        device."""
        return x[..., self.cols(j, x.device)].to(self.devices[j])

    def scatter(self, field: torch.Tensor) -> Dict[int, torch.Tensor]:
        """The local segments' columns of the full-width ``field``."""
        parts = {}
        for j in self.local:
            x0, x1 = self.bounds[j]
            parts[j] = field[..., x0:x1].to(self.devices[j])
            counters.scatter_bytes += _nbytes(parts[j])
        return parts

    def interior(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """Segment j's own columns of its window ``x``."""
        w = self.windows[j]
        return x[..., w.left:w.left + w.x1 - w.x0]

    # -- communication ------------------------------------------------------

    @contextlib.contextmanager
    def stepping(self):
        """Marks one lattice step: a gather inside it counts as a
        full-field gather per step."""
        counters.steps += 1
        self._in_step = True
        try:
            yield
        finally:
            self._in_step = False

    def exchange(self, parts: Dict[int, torch.Tensor]
                 ) -> Dict[int, torch.Tensor]:
        """Each local segment's window: its own columns and the halo
        columns fetched from the segments that own them."""
        remote = self._remote(parts) if self.ranks is not None else {}
        out = {}
        for j in self.local:
            dev, blocks = self.devices[j], []
            for p, (k, a, b) in enumerate(self.pieces[j]):
                if k == j:
                    blocks.append(parts[j][..., a:b])
                    continue
                x = remote[(j, p)] if (j, p) in remote else \
                    parts[k][..., a:b].to(dev)
                counters.halo_copies += 1
                counters.halo_bytes += _nbytes(x)
                blocks.append(x)
            out[j] = torch.cat(blocks, -1) if len(blocks) > 1 else blocks[0]
        return out

    def _remote(self, parts: Dict[int, torch.Tensor]
                ) -> Dict[Tuple[int, int], torch.Tensor]:
        """The pieces that cross a process boundary, sent and received in
        the same global order on every process."""
        import torch.distributed as dist

        like = parts[self.local[0]]
        reqs, got, tag = [], {}, 0
        for j, pieces in enumerate(self.pieces):
            for p, (k, a, b) in enumerate(pieces):
                tag += 1
                if self._is_local(j) == self._is_local(k):
                    continue
                if self._is_local(k):
                    reqs.append(dist.isend(parts[k][..., a:b].contiguous(),
                                           self.ranks[j], tag=tag))
                else:
                    buf = like.new_empty(like.shape[:-1] + (b - a,)).to(
                        self.devices[j])
                    reqs.append(dist.irecv(buf, self.ranks[k], tag=tag))
                    got[(j, p)] = buf
        for r in reqs:
            r.wait()
        return got

    def all_reduce(self, vals: Dict[int, torch.Tensor], device=None):
        """The sum of the local segments' ``vals`` over every segment (in
        segment order; exact for integers): on ``device`` if given, else
        {segment: the sum on its device}."""
        total = None
        for j in self.local:
            v = vals[j].to(self.devices[self.local[0]])
            total = v if total is None else total + v
        if self.ranks is not None:
            import torch.distributed as dist

            dist.all_reduce(total)
        counters.allreduces += 1
        counters.allreduce_bytes += _nbytes(total) * len(self.devices)
        if device is not None:
            return total.to(device)
        return {j: total.to(self.devices[j]) for j in self.local}

    def gather(self, parts: Dict[int, torch.Tensor], device) -> torch.Tensor:
        """The full-width field from every segment's columns, on
        ``device``."""
        if self._in_step:
            counters.step_gathers += 1
        else:
            counters.frame_gathers += 1
        if self.ranks is None:
            full = torch.cat([parts[j].to(device) for j in self.local], -1)
        else:
            full = self._all_gather(parts).to(device)
        counters.gather_bytes += _nbytes(full)
        return full

    def _all_gather(self, parts: Dict[int, torch.Tensor]) -> torch.Tensor:
        import torch.distributed as dist

        mine = torch.cat([parts[j] for j in self.local], -1).contiguous()
        every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        cols = {}
        for r, blk in enumerate(every):
            segs = [j for j in range(len(self.devices)) if self.ranks[j] == r]
            for i, j in enumerate(segs):
                cols[j] = blk[..., i * self.seg_len:(i + 1) * self.seg_len]
        return torch.cat([cols[j] for j in range(len(self.devices))], -1)
