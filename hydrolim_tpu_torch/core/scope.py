"""What the port does not cover yet, by the ROADMAP.md item that brings it.

Every entry point of the port raises ``not_ported(...)`` for a JAX package
option or engine outside its scope, so the message names the item of
ROADMAP.md §A that will port it.
"""
from __future__ import annotations

ROADMAP_ITEMS = {
    "host": "ROADMAP.md §A item 1, the host estimators and figures",
    "checkpointing": "ROADMAP.md §A item 2, checkpointing",
    "parallelism": "ROADMAP.md §A item 3, parallelism",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for ``what`` until ROADMAP.md's ``item`` lands."""
    return NotImplementedError(f"{what} is not ported yet "
                               f"({ROADMAP_ITEMS[item]})")
