"""Particle-run figures.

Re-creation of the reference's particle visualization inventory
(PARTICLE_solver_CLASS.py:561-978): the 3×2 overview panel and the ~14
individual figures (FFT mode amplitudes/phases, space–time heatmaps,
cluster-size histogram, bound-lifetime distribution, flux profile,
survival/FPT curves, exit positions, COM drift velocity, cumulative exits
per anchor), plus an animation writer (matplotlib-based; the reference uses
vispy, :980-1093 — used here only if installed).

A copy of the JAX package's ``viz/particle_plots.py`` (numpy only; it reads
the reference-schema ``out`` dict on the host).  The figures go through
``fit.veff_fit._pyplot``: where matplotlib is not installed no figure is
drawn, and ``plot_individuals`` still returns its COM drift velocity, which
it computes before any figure.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.observables.structure import cluster_size_distribution


def visualize_all(ps, out: Dict, show_k_max: int = 6,
                  cmap_name: str = "viridis", xlim: float = 1,
                  fig_size=(10, 6), save_path: Optional[str] = None,
                  plot_fft: bool = True) -> None:
    """3×2 overview panel (:561-661): m(t), FFT amplitudes (or exit count),
    unwrapped/raw mode phases (or bound count), m_local and total-density
    space–time heatmaps.  Nothing without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return
    times = out["times_obs"]
    T = times[-1]
    fft_amp = out.get("fft_amp_list")
    rho_hat = out.get("rho_hat_complex")
    colors = plt.get_cmap(cmap_name, show_k_max)

    fig, axes = plt.subplots(3, 2, figsize=fig_size, constrained_layout=True)
    ax00, ax01 = axes[0]
    ax10, ax11 = axes[1]
    ax20, ax21 = axes[2]

    ax00.plot(times, out["m_global"], label="m_global")
    ax00.set_xlabel("t")
    ax00.set_ylabel(r"$m^N(t)$")
    ax00.set_xlim(0, T)
    ax00.grid(True)
    ax00.legend(loc="upper left")

    if plot_fft and fft_amp is not None:
        for k in range(1, min(show_k_max + 1, fft_amp.shape[1])):
            ax01.plot(times, fft_amp[:, k] / ps.L, label=f"k={k}",
                      color=colors(k - 1), alpha=0.8)
        ax01.set_ylabel(r"$|A_k(t)|/L$")
    else:
        count = np.asarray(out["particle_count_list"], dtype=float)
        ax01.plot(times, count[0] - count)
        ax01.set_ylabel("# of exits")
    ax01.set_xlabel("t")
    ax01.set_xlim(0, T)
    ax01.grid(True)

    if plot_fft and rho_hat is not None:
        for k in range(1, min(show_k_max + 1, rho_hat.shape[1])):
            ax10.plot(times, np.unwrap(np.angle(rho_hat[:, k])),
                      label=f"k={k}", color=colors(k - 1), alpha=0.8)
        ax10.set_ylabel("unwrapped Arg$(A_k)$")
        ax10.legend()
        for k in range(1, min(show_k_max + 1, rho_hat.shape[1])):
            ax11.plot(times, np.angle(rho_hat[:, k]), label=f"k={k}",
                      color=colors(k - 1), alpha=0.8)
        ax11.set_ylabel("Arg$(A_k)$")
        ax11.legend()
        ax11.set_xlabel("t")
        ax11.set_xlim(0, T)
        ax11.grid(True)
    else:
        n_bound = np.asarray([np.sum(b) for b in out["bound_list"]]) \
            if out.get("bound_list") else np.zeros_like(times)
        ax10.plot(times, n_bound)
        ax10.set_ylabel("# of bound")
        ax11.text(0.5, 0.5, "FFT not recorded", ha="center", va="center")
        ax11.axis("off")
    ax10.set_xlabel("t")
    ax10.set_xlim(0, T)
    ax10.grid(True)

    im0 = ax20.imshow(out["m_local_list"], aspect="auto", origin="upper",
                      extent=[0, xlim, times[-1], 0], cmap=cmap_name,
                      vmin=-1, vmax=1)
    ax20.set_xlabel("x")
    ax20.set_ylabel("t")
    ax20.set_ylim([0, times[-1]])
    ax20.set_title("Local magnetization")
    fig.colorbar(im0, ax=ax20, label="m_local")

    im1 = ax21.imshow(out["total_list"], aspect="auto", origin="upper",
                      extent=[0, xlim, times[-1], 0], cmap=cmap_name,
                      vmin=0, vmax=7)
    ax21.set_xlabel("x")
    ax21.set_ylabel("t")
    ax21.set_ylim([0, times[-1]])
    ax21.set_title("Total density")
    fig.colorbar(im1, ax=ax21, label="rho_total")

    if save_path is not None:
        plt.savefig(save_path, dpi=200)
    plt.close(fig)


def bound_lifetimes(out: Dict) -> np.ndarray:
    """Bound-state lifetime samples.  Uses the framework's stable-slot
    ``bound_frames``/``alive_frames`` when present (exact particle identity;
    the reference's index-based tracking (:794-814) mislabels lifetimes when
    exits shift ids — SURVEY.md §2.4)."""
    times = np.asarray(out["times_obs"])
    bf = out.get("bound_frames")
    if bf is not None:
        bf = np.asarray(bf, dtype=bool)
        lifetimes = []
        entered = np.full(bf.shape[1], np.nan)
        for ti in range(bf.shape[0]):
            t = times[ti]
            newly = bf[ti] & np.isnan(entered)
            entered[newly] = t
            ended = ~bf[ti] & ~np.isnan(entered)
            lifetimes.extend((t - entered[ended]).tolist())
            entered[ended] = np.nan
        return np.asarray(lifetimes)
    # fallback: index-paired bound_list
    lifetimes = []
    active: Dict[int, float] = {}
    for ti, bound in enumerate(out.get("bound_list") or []):
        t = times[ti]
        n = len(bound)
        for pid in [p for p in active if p >= n]:
            del active[pid]
        for pid in range(n):
            if bound[pid] and pid not in active:
                active[pid] = t
            elif not bound[pid] and pid in active:
                lifetimes.append(t - active.pop(pid))
    return np.asarray(lifetimes)


def plot_individuals(ps, out: Dict, show_k_max: int = 6,
                     cmap_name: str = "viridis", xlim: float = 1,
                     fig_size=(10, 6), outdir: str = ".") -> float:
    """All individual figures (:663-978); returns the COM mean drift
    velocity like the reference.  The velocity is computed first, so it is
    returned where matplotlib is not installed and no figure is drawn."""
    times = np.asarray(out["times_obs"])
    # COM drift velocity (:901-915)
    total_density = np.asarray(out["total_list"])
    x_grid = np.linspace(0, 1.0, ps.L)
    mean_x = (total_density * x_grid).sum(axis=1) / (
        total_density.sum(axis=1) + 1e-12)
    v_eff = np.gradient(mean_x, times)
    mean_v_eff = float(np.mean(v_eff[int(len(v_eff) * 0.6):]))

    plt = _pyplot()
    if plt is None:
        return mean_v_eff
    od = Path(outdir)
    od.mkdir(parents=True, exist_ok=True)
    T = times[-1] if times.size else 0.0
    fft_amp = out.get("fft_amp_list")
    rho_hat = out.get("rho_hat_complex")
    var = out.get("var_list")
    colors = plt.get_cmap(cmap_name, show_k_max)

    def line_fig(y, ylabel, fname, series=None):
        plt.figure(figsize=fig_size)
        if series is None:
            plt.plot(times, y)
        else:
            for k, ys in series:
                plt.plot(times, ys, label=str(k), color=colors(k - 1),
                         alpha=0.6)
            plt.legend()
        plt.xlabel("t")
        plt.ylabel(ylabel)
        plt.xlim(0, T)
        plt.grid()
        plt.savefig(od / fname, dpi=200)
        plt.close()

    line_fig(out["m_global"], r"$m^N(t)$", "plot_t_m.png")
    if fft_amp is not None:
        ks = range(1, min(show_k_max + 1, fft_amp.shape[1]))
        line_fig(None, r"$|A_k(t)|$", "plot_t_A_K.png",
                 series=[(k, fft_amp[:, k] / ps.L) for k in ks])
    if rho_hat is not None:
        ks = range(1, min(show_k_max + 1, rho_hat.shape[1]))
        line_fig(None, "unwrapped Arg$(A_k(t))$", "plot_t_unwrap_Arg_A_K.png",
                 series=[(k, np.unwrap(np.angle(rho_hat[:, k]))) for k in ks])
        line_fig(None, "Arg$(A_k(t))$", "plot_t_Arg_A_K.png",
                 series=[(k, np.angle(rho_hat[:, k])) for k in ks])
    if var is not None:
        line_fig(var, "Var(t)", "plot_t_Var.png")

    # space–time heatmaps
    for arr, label, vlim, fname in (
            (out["m_local_list"], r"$m_{local}$", (-1, 1),
             "2D_plot_t_x_mlocal.png"),
            (out["total_list"], r"$\rho_{total}$", (0, 10),
             "2D_plot_t_x_total.png")):
        plt.figure(figsize=(10, 6))
        plt.imshow(arr, aspect="auto", origin="upper",
                   extent=[0, xlim, times[-1], 0], cmap=cmap_name,
                   vmin=vlim[0], vmax=vlim[1])
        plt.colorbar(label=label)
        plt.xlabel("x")
        plt.ylabel("time")
        plt.ylim(0, times[-1])
        plt.tight_layout()
        plt.savefig(od / fname, dpi=200)
        plt.close()

    # cluster-size histogram of the final profile (:766-792)
    sizes = cluster_size_distribution(np.asarray(out["total_list"])[-1], 1e-12)
    plt.figure(figsize=fig_size)
    plt.hist(sizes, bins=6, edgecolor="black")
    plt.xlabel("Cluster size")
    plt.ylabel("Frequency")
    plt.title("Histogram of cluster sizes (final)")
    plt.grid()
    plt.savefig(od / "cluster_size_histogram.png", dpi=200)
    plt.close()

    # bound-state lifetimes (:794-825)
    lifetimes = bound_lifetimes(out)
    if lifetimes.size:
        plt.figure(figsize=fig_size)
        plt.hist(lifetimes, bins=40, edgecolor="black")
        plt.xlabel("Bound-state lifetime")
        plt.ylabel("Count")
        plt.title("Distribution of bound-state lifetimes")
        plt.grid()
        plt.savefig(od / "lifetime_distribution.png", dpi=200)
        plt.close()

    # flux profile (:827-845)
    flux = (np.diff(out["rho_p_list"], axis=1)
            + np.diff(out["rho_m_list"], axis=1))
    plt.figure(figsize=(10, 6))
    plt.imshow(flux, aspect="auto", origin="upper",
               extent=[0, xlim, times[-1], 0], cmap="viridis", vmin=-3.5,
               vmax=3.5)
    plt.colorbar(label=r"Flux ($\Delta\rho_p + \Delta\rho_m$)")
    plt.xlabel("x")
    plt.ylabel("time")
    plt.title("Flux profile over space-time")
    plt.savefig(od / "flux_profile.png", dpi=200)
    plt.close()

    # survival / FPT (:847-887)
    N_t = np.asarray(out["particle_count_list"], dtype=float)
    N0 = N_t[0]
    S = N_t / N0
    flux_t = np.clip(-np.gradient(N_t, times), 0, None)
    total_exited = N0 - N_t[-1]
    fpt_pdf_cond = flux_t / total_exited if total_exited > 0 else flux_t * 0.0

    for y, ylabel, title, fname in (
            (S, "S(t)", "Survival curve", "FPT_survival_curve.png"),
            (fpt_pdf_cond, "f(t)", "First-passage time PDF (flux)",
             "FPT_flux_based.png")):
        plt.figure(figsize=fig_size)
        plt.plot(times, y)
        plt.xlabel("t")
        plt.ylabel(ylabel)
        plt.title(title)
        plt.grid(True)
        plt.savefig(od / fname, dpi=200)
        plt.close()

    exit_times = [t for t in (out.get("exit_times") or [])
                  if np.isfinite(t)]
    if exit_times:
        plt.figure(figsize=fig_size)
        plt.hist(exit_times, bins=80, density=True, alpha=0.8, edgecolor="k")
        plt.xlabel("Exit time")
        plt.ylabel("PDF")
        plt.title("First-passage times (event list)")
        plt.grid(True)
        plt.savefig(od / "FPT_event_histogram.png", dpi=200)
        plt.close()

    exit_pos = out.get("exit_positions") or []
    if len(exit_pos):
        plt.figure(figsize=fig_size)
        plt.hist(np.asarray(exit_pos) / ps.L, bins=50, alpha=0.8,
                 edgecolor="k")
        plt.xlabel("Exit position (normalized x)")
        plt.ylabel("Count")
        plt.title("Exit-position distribution")
        plt.grid(True)
        plt.savefig(od / "Exit_position_histogram.png", dpi=200)
        plt.close()

    plt.figure(figsize=fig_size)
    plt.plot(times, v_eff)
    plt.xlabel("t")
    plt.ylabel("v_eff(t)")
    plt.xlim(0, times[-1])
    plt.title("Effective drift velocity (COM method)")
    plt.grid(True)
    plt.savefig(od / "Effective_drift_velocity.png", dpi=200)
    plt.close()

    # cumulative exits per anchor (:917-976)
    anchors = getattr(ps.config, "anchor_positions", None) \
        if hasattr(ps, "config") else None
    if anchors:
        plot_cumulative_exits_by_anchor(ps, out, outdir=str(od))
    return mean_v_eff


def plot_cumulative_exits_by_anchor(ps, out: Dict, outdir: str = ".") -> None:
    plt = _pyplot()
    if plt is None:
        return
    config = ps.config
    times = np.asarray(out["times_obs"])
    # filter BOTH arrays by the same finiteness mask (a prefix slice would
    # misalign times and positions if a non-finite entry were interleaved
    # — cf. the paired zip in viz/exit_plots.py)
    all_t = np.asarray(out["exit_times"], dtype=float)
    all_x = np.asarray(out["exit_positions"], dtype=float)
    n = min(len(all_t), len(all_x))
    finite = np.isfinite(all_t[:n])
    exit_t = all_t[:n][finite]
    exit_x = all_x[:n][finite].astype(int)

    apos = np.asarray(config.anchor_positions, dtype=float)
    centers = np.unique(np.round((apos / config.xlim)
                                 * (config.L - 1)).astype(int))
    mask = config.anchor_mask()
    site_to_gid = np.full(config.L, -1, dtype=int)
    for s in np.where(mask)[0]:
        site_to_gid[s] = int(np.argmin(np.abs(centers - s)))

    gid = np.array([site_to_gid[x] if 0 <= x < config.L else -1
                    for x in exit_x])
    dt = times[1] - times[0] if len(times) > 1 else 1.0
    edges = np.concatenate([times, [times[-1] + dt]])
    centers_t = edges[:-1] + 0.5 * np.diff(edges)
    nA = len(centers)
    counts = np.zeros((len(centers_t), nA), dtype=int)
    for t, g in zip(exit_t, gid):
        if g >= 0:
            b = np.searchsorted(edges, t, side="right") - 1
            if 0 <= b < len(centers_t):
                counts[b, g] += 1
    cumA = np.cumsum(counts, axis=0)

    plt.figure(figsize=(7, 4))
    blues = plt.get_cmap("Blues")
    cols = [blues(0.55), blues(0.65), blues(0.75), blues(0.9)]
    for a in range(nA):
        plt.plot(centers_t, cumA[:, a], color=cols[a % 4], lw=2,
                 label=f"anchor {a}")
    plt.plot(centers_t, cumA.sum(axis=1), color=cols[3], lw=2, ls="--",
             label="total exits")
    plt.xlabel("t")
    plt.ylabel("Cumulative exits")
    plt.title("Cumulative exits per anchor")
    plt.xlim(0, times[-1])
    plt.grid()
    plt.legend()
    plt.tight_layout()
    plt.savefig(Path(outdir) / "cumulative_exits_by_anchor.png", dpi=200)
    plt.close()


def animate_profiles(ps, out: Dict, fname: str = "profiles.mp4",
                     fps: int = 20, stride: int = 1,
                     outdir: str = ".") -> Optional[str]:
    """Animation of ρ₊/ρ₋/m_local profiles over time.

    The reference uses a vispy realtime canvas + movie writer (:980-1093);
    here a matplotlib FuncAnimation writes the movie headlessly (falls back
    to a GIF via pillow when ffmpeg is unavailable, and returns None if
    neither writer exists, or matplotlib is not installed)."""
    plt = _pyplot()
    if plt is None:
        return None
    import matplotlib.animation as animation

    times = np.asarray(out["times_obs"])[::stride]
    rho_p = np.asarray(out["rho_p_list"])[::stride]
    rho_m = np.asarray(out["rho_m_list"])[::stride]
    m_loc = np.asarray(out["m_local_list"])[::stride]
    x = np.linspace(0, 1, ps.L)

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    lp, = ax1.plot(x, rho_p[0], label=r"$\rho_+$")
    lm, = ax1.plot(x, rho_m[0], label=r"$\rho_-$")
    ax1.set_ylim(0, max(1e-9, 1.1 * max(rho_p.max(), rho_m.max())))
    ax1.legend()
    ax1.grid(True)
    lmag, = ax2.plot(x, m_loc[0], color="navy")
    ax2.set_ylim(-1.05, 1.05)
    ax2.set_ylabel(r"$m_{local}$")
    ax2.set_xlabel("x")
    ax2.grid(True)
    title = ax1.set_title("t = 0")

    def update(i):
        lp.set_ydata(rho_p[i])
        lm.set_ydata(rho_m[i])
        lmag.set_ydata(m_loc[i])
        title.set_text(f"t = {times[i]:.2f}")
        return lp, lm, lmag, title

    anim = animation.FuncAnimation(fig, update, frames=len(times))
    path = Path(outdir) / fname
    try:
        anim.save(path, fps=fps, writer="ffmpeg")
    except Exception:
        try:
            path = path.with_suffix(".gif")
            anim.save(path, fps=fps, writer="pillow")
        except Exception:
            plt.close(fig)
            return None
    plt.close(fig)
    return str(path)
