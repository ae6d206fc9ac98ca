"""What the port does not cover yet, by the ROADMAP.md item that brings it.

An entry point of the port raises ``not_ported(...)`` for a JAX package
option outside its scope, so the message names the item of ROADMAP.md §A
that will port it.  Since lattice sharding landed the port covers every
module of the JAX package: the table is empty and no call is left.
"""
from __future__ import annotations

ROADMAP_ITEMS: dict = {}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for ``what`` until ROADMAP.md's ``item`` lands."""
    return NotImplementedError(f"{what} is not ported yet "
                               f"({ROADMAP_ITEMS[item]})")
