"""Realtime interactive profile viewer.

The reference ships a vispy realtime canvas
(``PARTICLE_solver_CLASS.py:980-1093`` ``animate_profiles``): four
Gaussian-smoothed profile lines (rho_plus cyan, rho_minus magenta, total
orange, m_local black) on a pan/zoom camera, a looping ``app.Timer``
playback at ``fps``, and an optional movie writer that captures each
rendered frame.  This module provides the same capability with a backend
ladder suited to this environment:

- ``'vispy'``  — delegate to a vispy SceneCanvas when vispy is importable
  and a display exists (closest to the reference; not installed here).
- ``'mpl'``    — matplotlib interactive window (``plt.ion`` + timer-driven
  looping playback, pan/zoom via the standard toolbar).  Requires a
  display.
- ``'headless'`` — offscreen Agg stepping: the same playback state
  machine without a window, with optional movie capture.  This is the
  CI-testable path and the automatic fallback on headless machines.

``backend='auto'`` picks the first available rung.  In every mode
``save_path`` captures exactly one full pass over the frames (the
reference captures whatever plays while the window is open; one loop is
the deterministic equivalent).

Deviations from the reference, both cosmetic: the reference multiplies
its x axis by ``spread_factor=10`` to fight vispy's aspect-locked camera
(``:1007-1010``) — matplotlib/Agg need no such trick, so x spans
``[0, xlim]`` directly; and the reference's y range is pinned to (-1, 3)
(``:1023``), which we keep as the default but expose as ``ylim``.

A copy of the JAX package's ``viz/realtime.py`` (numpy, scipy and
matplotlib on the host).  The viewer needs matplotlib; ``show_profiles``
returns None where it is not installed.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RealtimeProfileViewer", "show_profiles"]

# reference line colours (:1036-1060), RGBA
_COL_RHO_P = (0.0, 0.6, 1.0, 0.6)
_COL_RHO_M = (1.0, 0.0, 1.0, 0.6)
_COL_TOTAL = (1.0, 0.75, 0.0, 0.6)
_COL_M_LOC = (0.0, 0.0, 0.0, 0.6)


def _has_display() -> bool:
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


def _smooth_frames(arr: np.ndarray, sigma: float) -> np.ndarray:
    """Per-frame Gaussian smoothing, reference ``:992-999``.

    ``sigma == 0`` is the identity (the reference special-cases it; scipy
    would raise on sigma=0).  mode='nearest' matches the reference call."""
    if sigma == 0:
        return arr
    from scipy.ndimage import gaussian_filter1d

    return gaussian_filter1d(arr, sigma=sigma, mode="nearest", axis=-1)


class RealtimeProfileViewer:
    """Looping playback of rho+/rho-/total/m_local profiles.

    The playback state machine (frame index, wrap-around, per-frame line
    updates, movie capture) is backend-independent and exposed as
    :meth:`step` so the headless path exercises exactly the logic the
    interactive windows run.

    Parameters mirror the reference surface (``out, xlim, fps,
    smoothing_sigma, save_path``); ``m_local`` is deliberately NOT
    smoothed, as in the reference (``:1002`` smooths only the three
    density series).
    """

    def __init__(self, out: Dict, xlim: float = 1.0, fps: float = 30,
                 smoothing_sigma: float = 1.0,
                 save_path: Optional[str] = None,
                 backend: str = "auto",
                 ylim: Tuple[float, float] = (-1.0, 3.0)):
        self.times = np.asarray(out["times_obs"], dtype=float)
        rho_p = np.asarray(out["rho_p_list"], dtype=float)
        rho_m = np.asarray(out["rho_m_list"], dtype=float)
        total = np.asarray(out["total_list"], dtype=float)
        m_loc = np.asarray(out["m_local_list"], dtype=float)
        if rho_p.ndim != 2:
            raise ValueError(
                f"expected (frames, L) profile series, got {rho_p.shape}; "
                "batched runs: index one replica first")
        self.rho_p = _smooth_frames(rho_p, smoothing_sigma)
        self.rho_m = _smooth_frames(rho_m, smoothing_sigma)
        self.total = _smooth_frames(total, smoothing_sigma)
        self.m_local = m_loc
        self.n_frames = rho_p.shape[0]
        self.L = rho_p.shape[1]
        self.x = np.linspace(0.0, xlim, self.L)
        self.xlim = float(xlim)
        self.ylim = ylim
        self.fps = float(fps)
        self.save_path = save_path
        self.index = 0
        self.loops_completed = 0
        self.backend = self._resolve_backend(backend)
        self._writer = None
        self._fig = None
        self._lines = None
        self._build_figure()

    # -- backend selection ------------------------------------------------

    @staticmethod
    def _resolve_backend(backend: str) -> str:
        if backend not in ("auto", "vispy", "mpl", "headless"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "auto":
            if _has_display():
                try:
                    import vispy  # noqa: F401

                    return "vispy"
                except ImportError:
                    return "mpl"
            return "headless"
        if backend in ("vispy", "mpl") and not _has_display():
            raise RuntimeError(
                f"backend={backend!r} needs a display (DISPLAY unset); "
                "use backend='headless' or save a movie via "
                "viz.particle_plots.animate_profiles")
        return backend

    # -- figure ------------------------------------------------------------

    def _build_figure(self):
        import matplotlib

        if self.backend == "headless":
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        fig, ax = plt.subplots(figsize=(12, 7))
        (lp,) = ax.plot(self.x, self.rho_p[0], color=_COL_RHO_P, lw=2,
                        label=r"$\rho_+$")
        (lm,) = ax.plot(self.x, self.rho_m[0], color=_COL_RHO_M, lw=2,
                        label=r"$\rho_-$")
        (lt,) = ax.plot(self.x, self.total[0], color=_COL_TOTAL, lw=2,
                        label="total")
        (lml,) = ax.plot(self.x, self.m_local[0], color=_COL_M_LOC, lw=2,
                         label=r"$m_{local}$")
        ax.set_xlim(0.0, self.xlim)
        ax.set_ylim(*self.ylim)
        ax.axhline(0.0, color="black", lw=1)
        ax.set_xlabel("x")
        ax.legend(loc="upper right")
        self._title = ax.set_title(f"t = {self.times[0]:.3f}")
        self._fig = fig
        self._ax = ax
        self._lines = (lp, lm, lt, lml)

    # -- playback state machine ---------------------------------------------

    def step(self) -> int:
        """Render one frame and advance (wrapping) — reference ``update``
        (``:1071-1085``).  Returns the index of the frame just shown."""
        i = self.index
        lp, lm, lt, lml = self._lines
        lp.set_ydata(self.rho_p[i])
        lm.set_ydata(self.rho_m[i])
        lt.set_ydata(self.total[i])
        lml.set_ydata(self.m_local[i])
        self._title.set_text(f"t = {self.times[i]:.3f}")
        if self._writer is not None:
            self._writer.grab_frame()
        self.index += 1
        if self.index >= self.n_frames:
            self.index = 0
            self.loops_completed += 1
        return i

    # -- movie capture -------------------------------------------------------

    def _open_writer(self, path: Path):
        from matplotlib import animation

        if path.suffix == ".gif":
            w = animation.PillowWriter(fps=self.fps)
        else:
            if not animation.FFMpegWriter.isAvailable():
                path = path.with_suffix(".gif")
                w = animation.PillowWriter(fps=self.fps)
            else:
                w = animation.FFMpegWriter(fps=self.fps)
        w.setup(self._fig, str(path), dpi=100)
        self._writer = w
        self._save_path_final = path

    def _capture_one_loop(self) -> Optional[str]:
        path = Path(self.save_path)
        self._open_writer(path)
        start_loops = self.loops_completed
        while self.loops_completed == start_loops:
            self.step()
        self._writer.finish()
        self._writer = None
        return str(self._save_path_final)

    # -- run -------------------------------------------------------------------

    def run(self, n_frames: Optional[int] = None) -> Optional[str]:
        """Play.  Headless: step ``n_frames`` (default: one loop), saving
        the movie first if requested; returns the movie path or None.
        Interactive: capture the movie (if requested), then open the
        window and loop until closed."""
        saved = None
        if self.save_path is not None:
            saved = self._capture_one_loop()
            self.index = 0
        if self.backend == "headless":
            for _ in range(self.n_frames if n_frames is None else n_frames):
                self.step()
            self._plt.close(self._fig)
            return saved
        if self.backend == "vispy":
            self._run_vispy()
            return saved
        self._run_mpl_window()
        return saved

    def _run_mpl_window(self):
        plt = self._plt
        plt.ion()
        self._fig.show()
        timer = self._fig.canvas.new_timer(interval=int(1000.0 / self.fps))

        def _tick():
            self.step()
            self._fig.canvas.draw_idle()

        timer.add_callback(_tick)
        timer.start()
        plt.show(block=True)
        timer.stop()

    def _run_vispy(self):
        """Best-effort vispy parity path (reference ``:1009-1093``); only
        reachable when vispy is installed AND a display exists — neither
        holds in this image, so this stays a thin delegation."""
        from vispy import app, scene

        canvas = scene.SceneCanvas(keys="interactive", show=True,
                                   bgcolor="white", size=(1200, 700))
        view = canvas.central_widget.add_view()
        cam = scene.PanZoomCamera(aspect=None)
        view.camera = cam
        cam.set_range(x=(0.0, self.xlim), y=self.ylim)
        series = (self.rho_p, self.rho_m, self.total, self.m_local)
        cols = (_COL_RHO_P, _COL_RHO_M, _COL_TOTAL, _COL_M_LOC)
        lines = [scene.Line(pos=np.column_stack([self.x, s[0]]),
                            parent=view.scene, color=c, width=2)
                 for s, c in zip(series, cols)]

        def update(_ev):
            i = self.index
            for ln, s in zip(lines, series):
                ln.set_data(np.column_stack([self.x, s[i]]))
            self.index = (self.index + 1) % self.n_frames

        app.Timer(interval=1.0 / self.fps, connect=update, start=True)
        canvas.show()
        app.run()


def show_profiles(out: Dict, xlim: float = 1.0, fps: float = 30,
                  smoothing_sigma: float = 1.0,
                  save_path: Optional[str] = None,
                  backend: str = "auto") -> Optional[str]:
    """One-call surface matching the reference ``animate_profiles(out,
    xlim, fps, smoothing_sigma, save_path)`` signature; returns the saved
    movie path (or None when not saving, or without matplotlib)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: realtime viewer skipped",
              flush=True)
        return None
    return RealtimeProfileViewer(out, xlim=xlim, fps=fps,
                                 smoothing_sigma=smoothing_sigma,
                                 save_path=save_path,
                                 backend=backend).run()
