"""Trajectory, error and metric plots, numpy and matplotlib port of
`aicp_mapping_tpu.eval.plots`: the KITTI devkit's path and segment-error
plots, the risk classifier's decision region, and the per-frame overlap /
alignability / risk trace. matplotlib is imported inside each function
(Agg backend), so nothing else of the port needs it.
"""
from __future__ import annotations

import numpy as np


def plot_trajectories(path_png: str, poses_gt: np.ndarray | None,
                      poses_est: np.ndarray, title: str = "") -> None:
    """Bird's-eye (x, z for KITTI camera frame; falls back to x, y when the
    trajectory is flat in z) path plot."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def ground_axes(p):
        # pick the two axes with the largest spread
        spread = p[:, :3, 3].max(0) - p[:, :3, 3].min(0)
        a, b = np.argsort(spread)[-2:]
        return (min(a, b), max(a, b))

    ax_ids = ground_axes(poses_est if poses_gt is None else poses_gt)
    fig, ax = plt.subplots(figsize=(6, 6))
    if poses_gt is not None:
        ax.plot(poses_gt[:, ax_ids[0], 3], poses_gt[:, ax_ids[1], 3],
                "k-", lw=1.5, label="ground truth")
    ax.plot(poses_est[:, ax_ids[0], 3], poses_est[:, ax_ids[1], 3],
            "b-", lw=1.2, label="estimate")
    ax.scatter([poses_est[0, ax_ids[0], 3]], [poses_est[0, ax_ids[1], 3]],
               c="r", marker="o", s=30, label="start", zorder=3)
    ax.set_aspect("equal")
    ax.set_xlabel(f"axis {ax_ids[0]} [m]")
    ax.set_ylabel(f"axis {ax_ids[1]} [m]")
    ax.legend(loc="best", fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path_png, dpi=120)
    plt.close(fig)


def plot_segment_errors(path_png: str, errors, title: str = "") -> None:
    """t_err/r_err per segment length (plotErrorPlots analog)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from collections import defaultdict

    by_len_t = defaultdict(list)
    by_len_r = defaultdict(list)
    for e in errors:
        by_len_t[e.length].append(e.t_err)
        by_len_r[e.length].append(e.r_err)
    lens = sorted(by_len_t)
    t = [100.0 * np.mean(by_len_t[l]) for l in lens]
    r = [np.degrees(np.mean(by_len_r[l])) * 100.0 for l in lens]
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(9, 3.5))
    a1.plot(lens, t, "bs-")
    a1.set_xlabel("segment length [m]")
    a1.set_ylabel("translation error [%]")
    a2.plot(lens, r, "rs-")
    a2.set_xlabel("segment length [m]")
    a2.set_ylabel("rotation error [deg/100m]")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path_png, dpi=120)
    plt.close(fig)


def plot_decision_region(path_png: str, classifier,
                         features: np.ndarray | None = None,
                         labels: np.ndarray | None = None,
                         grid: int = 200, title: str = "") -> None:
    """Risk-classifier decision-region image over the (overlap, alignability)
    plane — the reference's SVM region rendering
    (aicp_core/src/classification/example.cpp) as a matplotlib figure.
    Optionally overlays a labelled dataset (green = success, red = failure).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ov = np.linspace(0.0, 100.0, grid, dtype=np.float32)
    al = np.linspace(0.0, 100.0, grid, dtype=np.float32)
    gx, gy = np.meshgrid(ov, al)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    probs = np.asarray(classifier.test(pts)).reshape(grid, grid)

    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(probs, origin="lower", extent=(0, 100, 0, 100),
                   aspect="auto", cmap="RdYlGn_r", vmin=0.0, vmax=1.0)
    ax.contour(gx, gy, probs, levels=[classifier.threshold],
               colors="k", linewidths=1.2)
    if features is not None and labels is not None:
        good = labels <= 0
        ax.scatter(features[good, 0], features[good, 1], c="g", s=12,
                   edgecolors="k", linewidths=0.3, label="success")
        ax.scatter(features[~good, 0], features[~good, 1], c="r", s=12,
                   edgecolors="k", linewidths=0.3, label="failure")
        ax.legend(loc="best", fontsize=8)
    fig.colorbar(im, ax=ax, label="P(alignment failure)")
    ax.set_xlabel("octree overlap [%]")
    ax.set_ylabel("alignability")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path_png, dpi=120)
    plt.close(fig)


def plot_frame_metrics(path_png: str, frames, title: str = "") -> None:
    """Overlap / alignability / risk per frame — the signal-scope live plot
    (plot_alignment_risk.py) as a static figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = np.arange(len(frames))
    fig, ax = plt.subplots(figsize=(8, 3.5))
    ax.plot(xs, [f.octree_overlap for f in frames], label="overlap %")
    align = [f.alignability for f in frames]
    if any(a >= 0 for a in align):
        ax.plot(xs, align, label="alignability")
    risk = [f.risk for f in frames]
    if any(r >= 0 for r in risk):
        ax.plot(xs, [100 * r for r in risk], label="risk x100")
    ax.set_xlabel("frame")
    ax.legend(loc="best", fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path_png, dpi=120)
    plt.close(fig)
