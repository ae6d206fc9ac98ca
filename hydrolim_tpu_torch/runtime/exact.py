"""The exact stationary law of a two-particle system on a small torus.

The ordered two-particle state space ((x₁, σ₁), (x₂, σ₂)) is enumerated,
the generator Q of the reference's channels is built (±1 diffusion at rate
rd into each free neighbour, σ-directed active hops at ra — plus_forward
gates them on σ = +1 — capacity-K blocking with optional crowding
suppression ×(1 − occ/K), Curie–Weiss flips exp(−βσm) with global m), and
πQ = 0 is solved.  π is projected onto the observable (counts₊, counts₋)
per site, the key the engines' frames give.  The JAX package's
``tests/test_native_gillespie.py`` solves the same law; here it serves the
port's tests and its GPU smoke.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import numpy as np


def two_particle_stationary_law(L: int, K: Optional[int], active_model: str,
                                rd: float, ra: float, beta: float,
                                crowding: bool = False
                                ) -> Dict[Tuple[int, ...], float]:
    """{(counts₊ per site…, counts₋ per site…): π} of two particles on a
    periodic lattice of L sites with capacity K (None: no exclusion)."""
    excl = K is not None
    singles = [(x, s) for x in range(L) for s in (-1, 1)]
    states = [p for p in itertools.product(singles, singles)
              if not (excl and K < 2 and p[0][0] == p[1][0])]
    index = {st: i for i, st in enumerate(states)}
    Q = np.zeros((len(states), len(states)))

    def hop_rate(base, st, t):
        if not excl:
            return base
        occ = sum(1 for (xx, _) in st if xx == t)
        if occ >= K:
            return 0.0
        return base * (1.0 - occ / K) if crowding else base

    for st, i in index.items():
        m = (st[0][1] + st[1][1]) / 2.0
        for k in (0, 1):
            (x, s), other = st[k], st[1 - k]
            moves = []
            for d in (-1, 1):
                t = (x + d) % L
                r = hop_rate(rd, st, t)
                if r > 0:
                    moves.append(((t, s), r))
            fstep = s if active_model == "bidirectional" else (
                1 if s == 1 else None)
            if fstep is not None:
                t = (x + fstep) % L
                r = hop_rate(ra, st, t)
                if r > 0:
                    moves.append(((t, s), r))
            moves.append(((x, -s), float(np.exp(-beta * s * m))))
            for single, rate in moves:
                new = (single, other) if k == 0 else (other, single)
                Q[i, index[new]] += rate
                Q[i, i] -= rate

    w, v = np.linalg.eig(Q.T)
    pi = np.abs(np.real(v[:, int(np.argmin(np.abs(w)))]))
    pi = pi / pi.sum()
    law: Dict[Tuple[int, ...], float] = {}
    for st, i in index.items():
        key = counts_key(st, L)
        law[key] = law.get(key, 0.0) + pi[i]
    return law


def counts_key(particles, L: int) -> Tuple[int, ...]:
    """(counts₊ per site…, counts₋ per site…) of ((x, σ), …)."""
    cp, cm = [0] * L, [0] * L
    for x, s in particles:
        (cp if s == 1 else cm)[x] += 1
    return tuple(cp) + tuple(cm)


def total_variation(law: Dict, counts: Dict) -> Tuple[float, float]:
    """(TV distance, mass outside the law's states) between ``law`` and the
    empirical frequencies of the observed ``counts`` keys ({key: n})."""
    n = float(sum(counts.values()))
    unseen = sum(c for k, c in counts.items() if k not in law) / n
    tv = 0.5 * sum(abs(p - counts.get(k, 0) / n) for k, p in law.items())
    return tv + 0.5 * unseen, unseen
