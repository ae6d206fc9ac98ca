"""The port's figure modules against the JAX package's, on the CPU.

``viz/particle_plots.py`` and ``viz/realtime.py`` read the reference-schema
``out`` dict on the host, so the two packages are held on the same numpy
dict: the port's ``ParticleSystem`` run (anchors, binding and exits at
tests/test_viz_smoke.py's size) is drawn by both.  ``plot_individuals``'
COM drift velocity and ``bound_lifetimes`` must be equal (k_off raised so
that bound states end within the run); the figure
inventory, the animation writer and the realtime viewer mirror
``tests/test_viz_smoke.py``; and with matplotlib hidden (the GPU host has
none) ``plot_individuals`` still returns its velocity and draws nothing.
"""
import os
import sys

import numpy as np
import pytest
import torch

from hydrolim_tpu import ParticleSystem as JParticleSystem
from hydrolim_tpu.viz import particle_plots as j_plots
from hydrolim_tpu_torch import ParticleSystem
from hydrolim_tpu_torch.viz import particle_plots, realtime

PS_KW = dict(L=64, xlim=1.0, rate_diffusion=0.5, rate_active=2.0, beta=1.5,
             init="fixed", N=30, scale_rates=False, local_kernel_sigma=0.02,
             periodic=False, site_capacity=3, anchor_positions=[0.4, 0.8],
             anchor_radius=0.05, k_on=5.0, k_off=4.0, k_exit=2.0, rng=1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_out():
    ps = ParticleSystem(**PS_KW, device="cpu")
    out = ps.run(T=2.0, obs_dt=0.25, record_fft=True, record_var=True)
    return ps, out


def test_plot_individuals_velocity_equals_jax(small_out, tmp_path):
    """The same out dict through both packages' ``plot_individuals``: the
    same COM drift velocity, to the bit, and the same figure inventory."""
    ps, out = small_out
    jps = JParticleSystem(**PS_KW)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    v_jax = j_plots.plot_individuals(jps, out, outdir=str(tmp_path / "jax"))
    v = ps.plot_individuals(out, outdir=str(tmp_path / "port"))
    assert np.isfinite(v) and v == v_jax
    produced = {p.name for p in (tmp_path / "port").glob("*.png")}
    assert produced == {p.name for p in (tmp_path / "jax").glob("*.png")}
    expected = {"plot_t_m.png", "plot_t_A_K.png", "plot_t_Var.png",
                "2D_plot_t_x_mlocal.png", "2D_plot_t_x_total.png",
                "cluster_size_histogram.png", "flux_profile.png",
                "FPT_survival_curve.png", "FPT_flux_based.png",
                "Effective_drift_velocity.png",
                "cumulative_exits_by_anchor.png"}
    assert expected <= produced, expected - produced


def test_bound_lifetimes_equal_jax(small_out):
    """Stable-slot lifetimes from ``bound_frames`` and the index-paired
    fallback from ``bound_list``, each equal to the JAX function's."""
    _, out = small_out
    assert np.asarray(out["bound_frames"]).any()
    got = particle_plots.bound_lifetimes(out)
    np.testing.assert_array_equal(got, j_plots.bound_lifetimes(out))
    assert got.size > 0
    paired = dict(out, bound_frames=None)
    np.testing.assert_array_equal(particle_plots.bound_lifetimes(paired),
                                  j_plots.bound_lifetimes(paired))


def test_visualize_all_and_animation_writer(small_out, tmp_path):
    ps, out = small_out
    ps.visualize_all(out, save_path=str(tmp_path / "overview.png"))
    assert (tmp_path / "overview.png").stat().st_size > 0
    path = ps.animate_profiles(out, stride=2, outdir=str(tmp_path))
    # no ffmpeg on either host: the pillow GIF
    assert path is not None and path.endswith((".mp4", ".gif"))
    assert os.path.getsize(path) > 0


def test_realtime_viewer_headless_loop_and_smoothing(small_out):
    ps, out = small_out
    v = realtime.RealtimeProfileViewer(out, backend="headless",
                                       smoothing_sigma=1.0)
    n = v.n_frames
    assert n == len(out["times_obs"]) and v.L == ps.L
    # one full pass + one extra step: index wraps, loop counter ticks
    shown = [v.step() for _ in range(n + 1)]
    assert shown == list(range(n)) + [0]
    assert v.loops_completed == 1 and v.index == 1
    np.testing.assert_allclose(v._lines[0].get_ydata(), v.rho_p[0])
    # sigma=0 is the identity, m_local never smoothed, and the smoothing is
    # the JAX module's
    from hydrolim_tpu.viz.realtime import _smooth_frames as j_smooth

    v0 = realtime.RealtimeProfileViewer(out, backend="headless",
                                        smoothing_sigma=0)
    np.testing.assert_array_equal(v0.rho_p, np.asarray(out["rho_p_list"]))
    np.testing.assert_array_equal(
        v.rho_p, j_smooth(np.asarray(out["rho_p_list"], float), 1.0))
    np.testing.assert_array_equal(v.m_local, np.asarray(out["m_local_list"]))
    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        with pytest.raises(RuntimeError, match="display"):
            realtime.RealtimeProfileViewer(out, backend="mpl")
    bad = dict(out, rho_p_list=np.asarray(out["rho_p_list"])[None])
    with pytest.raises(ValueError, match="replica"):
        realtime.RealtimeProfileViewer(bad, backend="headless")


def test_realtime_viewer_movie_capture(small_out, tmp_path):
    """``show_realtime`` defaults ``xlim`` to the config's and captures one
    loop headlessly."""
    ps, out = small_out
    path = ps.show_realtime(out, backend="headless", fps=10,
                            save_path=str(tmp_path / "rt.gif"))
    assert path is not None and path.endswith(".gif")
    assert os.path.getsize(path) > 0


@pytest.mark.parametrize("method,module,func", [
    ("visualize_all", particle_plots, "visualize_all"),
    ("plot_individuals", particle_plots, "plot_individuals"),
    ("animate_profiles", particle_plots, "animate_profiles"),
    ("show_realtime", realtime, "show_profiles"),
])
def test_system_methods_reach_the_port_modules(small_out, monkeypatch,
                                               method, module, func):
    """Each of ``ParticleSystem``'s four figure methods calls the port's
    own function (never the JAX package's), with the config's xlim where
    the JAX facade passes it."""
    ps, out = small_out
    seen = []
    monkeypatch.setattr(module, func,
                        lambda *a, **kw: seen.append((a, kw)) or "called")
    assert getattr(ps, method)(out) == "called"
    (args, kw), = seen
    assert args[-1] is out
    if method == "show_realtime":
        assert kw == {"xlim": ps.config.xlim}
    else:
        assert args[0] is ps


def test_figures_without_matplotlib(small_out, tmp_path, monkeypatch,
                                    capsys):
    """With matplotlib hidden, as on the GPU host: ``plot_individuals``
    returns the same velocity and writes no file; the other figure calls
    draw nothing and return None."""
    ps, out = small_out
    v_want = particle_plots.plot_individuals(ps, out,
                                             outdir=str(tmp_path / "a"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    od = tmp_path / "b"
    assert ps.plot_individuals(out, outdir=str(od)) == v_want
    assert not od.exists()
    assert ps.visualize_all(out, save_path=str(tmp_path / "o.png")) is None
    assert ps.animate_profiles(out, outdir=str(tmp_path)) is None
    assert ps.show_realtime(out, backend="headless",
                            save_path=str(tmp_path / "rt.gif")) is None
    assert not list(tmp_path.glob("*.png")) + list(tmp_path.glob("*.gif"))
    assert "matplotlib is not installed" in capsys.readouterr().out
