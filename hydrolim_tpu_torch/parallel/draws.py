"""The engines' per-step draws, and the draws of a batch split into shards.

The plain-torch engines (``lg_step``, ``lgk_step``, the τ-leap ``step``,
the torch fast path) and the plain versions of kernels B1, B2 and B3 draw
each step's random numbers for their whole batch from one
``torch.Generator``.  A torch generator is not prefix-stable in the batch:
row b of a (B, ·) draw is not row b of a (B', ·) draw.  So a shard that
drew (n, ·) from its own generator would leave the one-device trajectory.

``rand``, ``randn`` and ``randint`` are ``torch``'s with the generator
passed by position.  Given a ``ShardStream`` in place of the generator
they hand a shard its rows of the draw that the one-device run makes:
the first shard to ask for a draw makes it once for the real batch B on
the run's generator, in the one-device order, pads it to the padded batch
by repeating its last row, and every shard takes its rows of that
(``DrawTape``).  So the real replicas of a sharded run draw, bit for bit,
what they draw in the one-device run, and the generator ends where the
one-device run leaves it.  The shards must ask in lockstep: the tape holds
a draw until every shard has taken its rows.

A lattice split over a 'space' mesh axis (``parallel.spatial``) takes the
same draws by columns: a ``ColumnStream`` hands a segment the columns of
its window (its sites and the halo it recomputes, wrapping on a torus) of
the full-width draw, made once per draw at the run's width L from the
run's generator — or from a row block's ``ShardStream`` on a ('sweep',
'space') grid — in the one-device order (``ColumnTape``).  Each step thus
makes one full-width draw on the controlling device, as the one-device
run does, and the segments copy out their columns.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

_TORCH = {
    "rand": lambda shape, g, dev, dt: torch.rand(
        shape, generator=g, device=dev, dtype=dt),
    "randn": lambda shape, g, dev, dt: torch.randn(
        shape, generator=g, device=dev, dtype=dt),
}


def _draw(kind: str, args: tuple, shape, generator, device, dtype):
    if kind == "randint":
        return torch.randint(*args, shape, generator=generator,
                             device=device, dtype=dtype)
    return _TORCH[kind](shape, generator, device, dtype)


class DrawTape:
    """The draws of one range of a sharded run: ``generator`` (the run's,
    on the controlling device), the real batch ``B`` and, per shard i
    this process runs, its rows ``bounds[i] = (lo, hi)`` of the padded
    batch.  Draw j is made when the first shard asks for it and dropped
    when the last has taken its rows."""

    def __init__(self, generator: torch.Generator, B: int, Bp: int,
                 bounds: Dict[int, Tuple[int, int]]):
        self.generator, self.B, self.Bp, self.bounds = generator, B, Bp, bounds
        self._taken = {i: 0 for i in bounds}
        self._held: Dict[int, list] = {}

    def take(self, shard: int, kind: str, args: tuple, shape, device,
             dtype) -> torch.Tensor:
        j = self._taken[shard]
        self._taken[shard] = j + 1
        lo, hi = self.bounds[shard]
        key = (kind, args, tuple(shape[1:]), dtype)
        if shape[0] != hi - lo:
            raise ValueError(f"shard {shard} drew {tuple(shape)} for its "
                             f"{hi - lo} rows")
        held = self._held.get(j)
        if held is None:
            full = _draw(kind, args, (self.B,) + tuple(shape[1:]),
                         self.generator, self.generator.device, dtype)
            if self.Bp > self.B:
                full = torch.cat([full, full[-1:].expand(
                    self.Bp - self.B, *full.shape[1:])])
            held = self._held[j] = [key, full, len(self.bounds)]
        elif held[0] != key:
            raise RuntimeError(f"shard {shard}'s draw {j} is {key}, another "
                               f"shard's is {held[0]}: the shards ran out of "
                               "step")
        out = held[1][lo:hi].to(device)
        held[2] -= 1
        if held[2] == 0:
            del self._held[j]
        return out


class ShardStream:
    """Shard ``shard``'s view of a ``DrawTape``, passed to an engine where
    it takes a generator."""

    def __init__(self, tape: DrawTape, shard: int):
        self.tape, self.shard = tape, shard

    def take(self, kind: str, args: tuple, shape, device, dtype):
        return self.tape.take(self.shard, kind, args, shape, device, dtype)


class ColumnTape:
    """The draws of one step of a lattice split into segments: draw j is
    made once at the full width ``L`` from ``source`` (the run's generator,
    or a row block's ``ShardStream``) on ``device``, and each segment i
    takes its window's columns ``layer.take(draw, i)``
    (``parallel.halo.HaloLayer``).  A draw is dropped when every segment
    has taken it."""

    def __init__(self, source, device, layer):
        self.source, self.device, self.layer = source, device, layer
        self._taken = {i: 0 for i in layer.local}
        self._held: Dict[int, list] = {}
        self.bytes_drawn = 0

    def take(self, seg: int, kind: str, args: tuple, shape, device,
             dtype) -> torch.Tensor:
        j = self._taken[seg]
        self._taken[seg] = j + 1
        key = (kind, args, tuple(shape[:-1]), dtype)
        held = self._held.get(j)
        if held is None:
            full = draw(kind, args, tuple(shape[:-1]) + (self.layer.L,),
                        self.source, self.device, dtype)
            self.bytes_drawn += full.numel() * full.element_size()
            held = self._held[j] = [key, full, len(self._taken)]
        elif held[0] != key:
            raise RuntimeError(f"segment {seg}'s draw {j} is {key}, another "
                               f"segment's is {held[0]}: the segments ran "
                               "out of step")
        out = self.layer.take(held[1], seg)
        if out.shape[-1] != shape[-1]:
            raise ValueError(f"segment {seg} drew {tuple(shape)} for a "
                             f"window of {out.shape[-1]} columns")
        held[2] -= 1
        if held[2] == 0:
            del self._held[j]
        return out


class ColumnStream:
    """Segment ``seg``'s view of a ``ColumnTape``, passed to an engine where
    it takes a generator."""

    def __init__(self, tape: ColumnTape, seg: int):
        self.tape, self.seg = tape, seg

    def take(self, kind: str, args: tuple, shape, device, dtype):
        return self.tape.take(self.seg, kind, args, shape, device, dtype)


_STREAMS = (ShardStream, ColumnStream)


def draw(kind: str, args: tuple, shape, source, device, dtype
         ) -> torch.Tensor:
    """One draw of ``kind`` ('rand', 'randn' or 'randint' with ``args`` =
    (low, high)) from a generator or a stream."""
    if isinstance(source, _STREAMS):
        return source.take(kind, args, shape, device, dtype)
    return _draw(kind, args, shape, source, device, dtype)


def rand(shape, generator=None, device=None, dtype=None) -> torch.Tensor:
    """``torch.rand(shape, generator=, device=, dtype=)``, or a shard's rows
    of it (``ShardStream``) or a segment's columns (``ColumnStream``)."""
    return draw("rand", (), shape, generator, device, dtype)


def randn(shape, generator=None, device=None, dtype=None) -> torch.Tensor:
    """``torch.randn``, as ``rand``."""
    return draw("randn", (), shape, generator, device, dtype)


def randint(low: int, high: int, shape, generator=None, device=None,
            dtype=None) -> torch.Tensor:
    """``torch.randint(low, high, shape, ...)``, as ``rand``."""
    return draw("randint", (low, high), shape, generator, device, dtype)


def shard_streams(generator: Optional[torch.Generator], B: int, Bp: int,
                  bounds: Dict[int, Tuple[int, int]]
                  ) -> Dict[int, Optional[ShardStream]]:
    """One ``ShardStream`` per shard over a fresh tape of ``generator``
    (None where the run has no generator)."""
    if generator is None:
        return {i: None for i in bounds}
    tape = DrawTape(generator, B, Bp, bounds)
    return {i: ShardStream(tape, i) for i in bounds}


def column_streams(source, device, layer) -> Dict[int, ColumnStream]:
    """One ``ColumnStream`` per local segment of ``layer`` over a fresh
    tape of ``source``."""
    tape = ColumnTape(source, device, layer)
    return {i: ColumnStream(tape, i) for i in layer.local}


class RowDraws:
    """Rows [b0, b0 + n) of injected draws (the tests' ``_draws``: every
    ``step(i)`` tensor leads with the batch), the last row repeated past
    the batch as ``mesh.pad_batch`` pads: a block's share of them."""

    def __init__(self, draws, b0: int, n: int):
        self.draws, self.b0, self.n = draws, b0, n

    def step(self, i: int):
        def rows(x):
            x = x[self.b0:self.b0 + self.n]
            if x.shape[0] < self.n:
                x = torch.cat([x, x[-1:].expand(self.n - x.shape[0],
                                                *x.shape[1:])])
            return x

        return tuple(rows(x) for x in self.draws.step(i))
