"""Matplotlib diagnostics graphs (``ptudes_tpu.viz.graphs``; reference
``src/ptudes/ins/viz_utils.py``).

Array-native re-design: the reference plots from python lists accumulated
inside the ESEKF object (``_navs``, ``_lg_acc`` ...); here every plot takes
the stacked arrays that the functional filters/pipelines already return
(``esekf.FilterLog``, ``lio.LioOut``). All functions accept ``show=False``
and return the figure for headless testing/saving. Every argument is
host data (numpy arrays, or a ``FilterLog`` flattened by
``lio.flatten_filter_log``).

matplotlib is imported at the first plot, not with this module: without
it a plot raises ``PlotUnavailable`` and everything else runs.
"""
from __future__ import annotations

import numpy as np


class PlotUnavailable(RuntimeError):
    """A plot was asked for where matplotlib is not installed."""


def _plt():
    try:
        import matplotlib  # noqa: F401
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise PlotUnavailable(
            "plotting needs matplotlib, which is not installed "
            f"({e})") from e
    return plt


def _quat_to_euler_deg(quats: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation
    return Rotation.from_quat(quats).as_euler("XYZ", degrees=True)


def ekf_graphs(
    log,                      # esekf.FilterLog (stacked arrays)
    imu_lacc: np.ndarray | None = None,
    imu_avel: np.ndarray | None = None,
    gt: tuple | None = None,  # (t, poses [K, 4, 4])
    gt2: tuple | None = None,  # second overlay (reference ouster mode
    #                            passes kiss-only poses as gt and the true
    #                            GT as gt2, src/ptudes/cli/ekf_bench.py:641-648)
    xy_plot: bool = False,
    labels: list[str] | None = None,
    show: bool = True,
):
    """Acc/gyr + bias traces with trajectory panels (reference
    ``ekf_graphs``, ``src/ptudes/ins/viz_utils.py:73-193``)."""
    plt = _plt()
    t = np.asarray(log.ts)
    t = t - t[0]
    pos = np.asarray(log.pos)
    labels = labels or ["EKF"]

    fig, axs = plt.subplots(6, 3, figsize=(14, 12), sharex=False)
    names_acc = ["acc X", "acc Y", "acc Z"]
    names_gyr = ["gyr X", "gyr Y", "gyr Z"]
    for i in range(3):
        if imu_lacc is not None:
            m = min(len(t), len(imu_lacc))
            axs[0, i].plot(t[:m], np.asarray(imu_lacc)[:m, i], lw=0.5)
        axs[0, i].set_title(names_acc[i], fontsize=8)
        if imu_avel is not None:
            m = min(len(t), len(imu_avel))
            axs[1, i].plot(t[:m], np.asarray(imu_avel)[:m, i], lw=0.5)
        axs[1, i].set_title(names_gyr[i], fontsize=8)
        axs[2, i].plot(t, np.asarray(log.bias_acc)[:, i])
        axs[2, i].set_title(f"bias acc {'XYZ'[i]}", fontsize=8)
        axs[3, i].plot(t, np.asarray(log.bias_gyr)[:, i])
        axs[3, i].set_title(f"bias gyr {'XYZ'[i]}", fontsize=8)
        axs[4, i].plot(t, np.asarray(log.vel)[:, i])
        axs[4, i].set_title(f"vel {'XYZ'[i]}", fontsize=8)

    # trajectory panels
    overlays = [(g, i) for i, g in enumerate((gt, gt2), start=1)
                if g is not None]
    if xy_plot:
        axs[5, 0].plot(pos[:, 0], pos[:, 1], label=labels[0])
        for g, li in overlays:
            gt_pos = np.asarray(g[1])[:, :3, 3]
            axs[5, 0].plot(gt_pos[:, 0], gt_pos[:, 1], "--",
                           label=labels[li] if len(labels) > li
                           else f"overlay {li}")
        axs[5, 0].set_title("XY", fontsize=8)
        axs[5, 0].legend(fontsize=6)
        axs[5, 1].plot(t, pos[:, 2])
        for g, li in overlays:
            gt_t = np.asarray(g[0]) - np.asarray(g[0])[0]
            axs[5, 1].plot(gt_t, np.asarray(g[1])[:, 2, 3], "--")
        axs[5, 1].set_title("Z", fontsize=8)
    else:
        for i in range(3):
            axs[5, i].plot(t, pos[:, i], label=labels[0])
            for g, li in overlays:
                gt_t = np.asarray(g[0]) - np.asarray(g[0])[0]
                gt_pos = np.asarray(g[1])[:, :3, 3]
                axs[5, i].plot(gt_t, gt_pos[:, i], "--",
                               label=labels[li] if len(labels) > li
                               else f"overlay {li}")
            axs[5, i].set_title(f"pos {'XYZ'[i]}", fontsize=8)
        axs[5, 0].legend(fontsize=6)
    for ax in axs.ravel():
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def ekf_error_graphs(log_gt, log, show: bool = True):
    """GT-vs-filter position/attitude error traces with update-knot markers
    (reference ``ekf_error_graphs``, ``src/ptudes/ins/viz_utils.py:205-314``)."""
    plt = _plt()
    t = np.asarray(log.ts)
    t = t - t[0]
    dpos = np.asarray(log.pos) - np.asarray(log_gt.pos)
    eul = _quat_to_euler_deg(np.asarray(log.att_q))
    eul_gt = _quat_to_euler_deg(np.asarray(log_gt.att_q))
    deul = (eul - eul_gt + 180.0) % 360.0 - 180.0
    upd = np.asarray(log.updated)

    fig, axs = plt.subplots(2, 3, figsize=(14, 6))
    for i in range(3):
        axs[0, i].plot(t, dpos[:, i])
        axs[0, i].plot(t[upd], dpos[upd, i], "r.", ms=3)
        axs[0, i].set_title(f"pos err {'XYZ'[i]} (m)", fontsize=8)
        axs[1, i].plot(t, deul[:, i])
        axs[1, i].plot(t[upd], deul[upd, i], "r.", ms=3)
        axs[1, i].set_title(f"att err {'XYZ'[i]} (deg)", fontsize=8)
        axs[0, i].grid(True, alpha=0.3)
        axs[1, i].grid(True, alpha=0.3)
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def gt_poses_graphs(
    pose_sets: list,          # list of [(t, pose4x4), ...] trajectories
    xy_plot: bool = False,
    labels: list[str] | None = None,
    show: bool = True,
):
    """Multi-trajectory comparison plots (reference ``gt_poses_graphs``,
    ``src/ptudes/ins/viz_utils.py:16-70``)."""
    plt = _plt()
    labels = labels or [f"traj {i}" for i in range(len(pose_sets))]
    if xy_plot:
        fig, axs = plt.subplots(1, 2, figsize=(12, 5))
        for ps, lb in zip(pose_sets, labels):
            t = np.asarray([x[0] for x in ps])
            p = np.asarray([x[1] for x in ps])[:, :3, 3]
            axs[0].plot(p[:, 0], p[:, 1], label=lb)
            axs[1].plot(t - t[0], p[:, 2], label=lb)
        axs[0].set_title("XY")
        axs[1].set_title("Z(t)")
        for ax in axs:
            ax.grid(True, alpha=0.3)
            ax.legend(fontsize=7)
    else:
        fig, axs = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
        for ps, lb in zip(pose_sets, labels):
            t = np.asarray([x[0] for x in ps])
            p = np.asarray([x[1] for x in ps])[:, :3, 3]
            for i in range(3):
                axs[i].plot(t - t[0], p[:, i], label=lb)
        for i, ax in enumerate(axs):
            ax.set_title(f"pos {'XYZ'[i]}", fontsize=9)
            ax.grid(True, alpha=0.3)
        axs[0].legend(fontsize=7)
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def kiss_innovation_graph(ts, err_dt, err_drot, sigmas, show: bool = True):
    """KISS innovation + adaptive sigma traces (reference plot at
    ``src/ptudes/cli/ekf_bench.py:651-659``)."""
    plt = _plt()
    fig = plt.figure(figsize=(10, 5))
    rel_t = np.asarray(ts) - np.asarray(ts)[0]
    plt.plot(rel_t, np.asarray(err_dt), label="KissICP: trans error (m)")
    plt.plot(rel_t, np.asarray(err_drot),
             label="KissICP: rotation error (rad)")
    plt.plot(rel_t, np.asarray(sigmas),
             label="KissICP: adaptive threshold sigma")
    plt.grid(True)
    plt.xlabel("t (s)")
    plt.legend(loc="upper right")
    if show:
        plt.show()
    return fig
