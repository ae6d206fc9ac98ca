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


def rand(shape, generator=None, device=None, dtype=None) -> torch.Tensor:
    """``torch.rand(shape, generator=, device=, dtype=)``, or a shard's rows
    of it (``ShardStream``)."""
    if isinstance(generator, ShardStream):
        return generator.take("rand", (), shape, device, dtype)
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)


def randn(shape, generator=None, device=None, dtype=None) -> torch.Tensor:
    """``torch.randn``, as ``rand``."""
    if isinstance(generator, ShardStream):
        return generator.take("randn", (), shape, device, dtype)
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


def randint(low: int, high: int, shape, generator=None, device=None,
            dtype=None) -> torch.Tensor:
    """``torch.randint(low, high, shape, ...)``, as ``rand``."""
    if isinstance(generator, ShardStream):
        return generator.take("randint", (low, high), shape, device, dtype)
    return torch.randint(low, high, shape, generator=generator,
                         device=device, dtype=dtype)


def shard_streams(generator: Optional[torch.Generator], B: int, Bp: int,
                  bounds: Dict[int, Tuple[int, int]]
                  ) -> Dict[int, Optional[ShardStream]]:
    """One ``ShardStream`` per shard over a fresh tape of ``generator``
    (None where the run has no generator)."""
    if generator is None:
        return {i: None for i in bounds}
    tape = DrawTape(generator, B, Bp, bounds)
    return {i: ShardStream(tape, i) for i in bounds}

