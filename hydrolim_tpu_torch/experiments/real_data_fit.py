"""Kinesin-II real-data validation fit (fit_over_real_data.py); the JAX
package's ``experiments/run_real_data_fit.py``.  Host work only (scipy):
it writes ``kinesin_fit.json`` into ``--outdir`` and, with matplotlib, the
two figures.

Usage: python -m hydrolim_tpu_torch.experiments.real_data_fit [--outdir DIR]
"""
from __future__ import annotations

import argparse

from hydrolim_tpu_torch.fit.real_data import main as fit_main

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="real_data_out")
    a = p.parse_args()
    fit_main(a.outdir)
