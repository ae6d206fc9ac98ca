"""What the runners share.  A traffic mix is a data file
(``portbench/traffic/<mix>.json``) whose ``runner`` names a file
``portbench/runners/<runner>.py`` that defines ``Runner``, a subclass of
``BaseRunner``; the mix's other keys are its parameters, the sizes come
from the configuration's file.  A runner makes a unit of work (one sweep,
the unit a user waits for) from a seed, runs it through the program's
entry, counts its work and keeps what the check needs.

The program's layers are timed from here: a runner wraps the call into
the run loop (``solve``) and counts the rest of a unit as the host
estimators'.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.spans import Spans


def unit_seed(seed: int, k: int) -> int:
    """The seed of unit k of a run seeded with ``seed``."""
    return int(np.random.SeedSequence([int(seed), k]).generate_state(1)[0]
               & 0x7FFFFFFF)


@contextlib.contextmanager
def tap(module, name: str, wrapper: Callable):
    """Replace ``module.name`` by ``wrapper(original)`` while inside."""
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def betas_of(spec: dict) -> np.ndarray:
    """The β grid of a configuration: ``{"start", "stop", "num"}``."""
    return np.linspace(spec["start"], spec["stop"], spec["num"])


@dataclasses.dataclass
class Calls:
    """The kernel calls of a unit, for the per-layer bounds."""

    b1: List[dict] = dataclasses.field(default_factory=list)
    b2: List[dict] = dataclasses.field(default_factory=list)
    spectra: List[dict] = dataclasses.field(default_factory=list)


class BaseRunner:
    """One cell's traffic: ``warm`` runs a unit of the cell's shapes,
    ``unit`` runs one unit and returns its work, ``check`` compares the
    kept unit with the reference and ``control`` puts the reference in a
    lower precision in the program's place."""

    def __init__(self, config: dict, traffic: dict, device, spans: Spans,
                 sync: bool, shrink: Optional[dict] = None):
        self.cfg = dict(config)
        if shrink:
            self.cfg.update(shrink)
        self.traffic, self.device, self.spans = traffic, device, spans
        self.sync = sync and torch.device(device).type == "cuda"
        self.kept = None          # what the check reads of the kept unit

    def _sync(self):
        if self.sync:
            torch.cuda.synchronize()

    def warm(self) -> None:
        raise NotImplementedError

    def unit(self, seed: int, keep: bool) -> float:
        raise NotImplementedError

    def calls(self) -> Calls:
        """The kernel calls of one unit."""
        raise NotImplementedError

    def check(self) -> Dict[str, float]:
        raise NotImplementedError

    def control(self, dtype) -> Dict[str, float]:
        raise NotImplementedError

    def close(self) -> None:
        pass


# --- the PDE runners' comparison of the program's result with the
# reference's (``reference.pde.PDERun``)

def b2_calls(config, B: int) -> Calls:
    """B2's and the spectra kernel's calls of one ``pde_solve_fused``
    (one a snapshot block), from the program's configuration."""
    n0s = range(0, config.nsteps + 1, config.snapshot_interval)
    ks = [min(config.snapshot_interval, config.nsteps - n0) for n0 in n0s]
    common = dict(L=config.L, n_t=config.n_tracers,
                  window=config.tracer_window, kmax=config.kmax, B=B)
    return Calls(
        b2=[dict(common, k=k) for k in ks if k > 0],
        spectra=[dict(rows=B * k, L=config.L, kmax=config.kmax)
                 for k in ks if k > 0 and config.kmax > 0])


def pde_gaps(out: dict, got, ref, keep: bool, early_steps: int) -> dict:
    """Readings of the program's result ``got`` against the reference's
    ``ref``: the fields and snapshots relative to their largest value, m
    absolute, the other records relative to their largest magnitude (inf
    where one side is NaN and the other not); m also over its first
    ``early_steps`` rows alone."""
    host = lambda t: t.detach().double().cpu().numpy()

    def rel(a, b, absolute=False):
        a, b = np.asarray(a, float), np.asarray(b, float)
        if (np.isnan(a) != np.isnan(b)).any():
            return float("inf")
        ok = ~np.isnan(b)
        if not ok.any():
            return 0.0
        d = np.abs(a[ok] - b[ok]).max()
        return float(d if absolute else d / max(np.abs(b[ok]).max(), 1e-30))
    rec = got.records
    fields = max(rel(got.rho_p, host(ref.rho_p)),
                 rel(got.rho_m, host(ref.rho_m)))
    if keep:
        fields = max(fields, rel(got.snapshots, host(ref.snapshots)),
                     rel(got.m_snapshots, host(ref.m_snapshots)))
    out["fields"] = fields
    out["m_record"] = rel(rec.m_mean, host(ref.m_mean), absolute=True)
    # m over the first block, before the ordered phase's instability can
    # amplify the two sides' roundoff
    early = slice(0, early_steps)
    out["m_record_early"] = rel(rec.m_mean[:, early],
                                host(ref.m_mean)[:, early], absolute=True)
    out["var_record"] = rel(rec.var, host(ref.var))
    out["spectra_record"] = max(rel(rec.fft_ri[..., 0], host(ref.fft_re)),
                                rel(rec.fft_ri[..., 1], host(ref.fft_im)))
    out["v_eff_record"] = rel(rec.v_eff, host(ref.v_eff))
    out["D_eff_record"] = rel(rec.D_eff, host(ref.D_eff))
    return out


def as_result(run):
    """A reference run in the layout of the program's numpy result."""
    host = lambda t: None if t is None else t.detach().cpu().numpy()
    rec = types.SimpleNamespace(
        m_mean=host(run.m_mean), var=host(run.var), v_eff=host(run.v_eff),
        D_eff=host(run.D_eff),
        fft_ri=np.stack([host(run.fft_re), host(run.fft_im)], -1))
    return types.SimpleNamespace(rho_p=host(run.rho_p), rho_m=host(run.rho_m),
                                 snapshots=host(run.snapshots),
                                 m_snapshots=host(run.m_snapshots),
                                 records=rec)
