"""Frame cadence of the particle runs."""
from __future__ import annotations

import math


def substeps_for(obs_dt: float, dt_target: float) -> int:
    """Δt sub-steps per observation frame, with a sanity bound against a
    garbage dt (e.g. an absurd β underflowing the rate bound)."""
    assert math.isfinite(dt_target) and dt_target > 0.0, (
        f"dt must be positive and finite, got {dt_target!r}")
    n = max(1, int(math.ceil(obs_dt / dt_target - 1e-9)))
    assert n <= 100_000_000, (
        f"{n} sub-steps per obs_dt frame (obs_dt={obs_dt!r}, "
        f"dt={dt_target!r}) — dt is implausibly small; check the rate/beta "
        "configuration passed to ensemble_dt")
    return n
