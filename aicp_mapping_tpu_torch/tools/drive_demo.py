"""Drive the AICP pipeline with failure prediction over a drifting
synthetic sequence, the port of `aicp_mapping_tpu/tools/drive_demo.py`:
a risk classifier trained on synthetic features, 12 frames of 10,000
points through `App(visualizer=RecordingVisualizer())`, and the demo's
two assertions (the corrected end point no worse than odometry's, every
frame accepted).

    python -m aicp_mapping_tpu_torch.tools.drive_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def run(device="cuda", n_frames: int = 12) -> dict:
    """The demo on `device`; returns its App, frames, sink and errors after
    asserting what the JAX script asserts."""
    from ..classification import RiskClassifier
    from ..pipeline import (App, PipelineConfig, SequenceRunner,
                            synthetic_sequence)
    from ..utils.visualizer import RecordingVisualizer

    cfg = PipelineConfig(working_mode="debug", raw_capacity=16384,
                         downsample_capacity=8192, filtered_capacity=4096,
                         map_capacity=65536, align_ds_capacity=2048,
                         align_max_clusters=16, min_cluster_size=30,
                         failure_prediction_mode=True)

    # a classifier trained on synthetic risk data, so that the failure
    # prediction path runs: risk only when both features collapse
    rng = np.random.default_rng(0)
    ov = rng.uniform(0, 100, 300)
    al = rng.uniform(0, 30, 300)
    y = ((ov < 12) & (al < 3)).astype(np.float32)
    clf = RiskClassifier(0.5, device=device)
    clf.train(np.stack([ov, al], 1), y, steps=1500)

    items, gt = synthetic_sequence(n_frames=n_frames, n_points=10000, seed=1)
    vis = RecordingVisualizer()
    app = App(cfg, device=device, visualizer=vis, classifier=clf)
    runner = SequenceRunner(app)
    t0 = time.perf_counter()
    frames = runner.run_clouds(items[:2])
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames += runner.run_clouds(items[2:])
    t_rest = time.perf_counter() - t0
    app.close()

    odom_err = [float(np.linalg.norm(it[2][:3, 3] - g[:3, 3]))
                for it, g in zip(items, gt)]
    corr_err = [float(np.linalg.norm(f.corrected_pose[:3, 3] - g[:3, 3]))
                for f, g in zip(frames, gt)]
    print(f"frames={len(frames)} accepted={sum(f.accepted for f in frames)} "
          f"registered={sum(f.registered for f in frames)}")
    print(f"final odom drift={odom_err[-1] * 100:.1f}cm -> "
          f"corrected={corr_err[-1] * 100:.1f}cm")
    rest = frames[1:]
    print(f"overlap range: {min(f.octree_overlap for f in rest):.0f}-"
          f"{max(f.octree_overlap for f in rest):.0f}%")
    print(f"alignability range: {min(f.alignability for f in rest):.1f}-"
          f"{max(f.alignability for f in rest):.1f}")
    print(f"risk range: {min(f.risk for f in rest):.2f}-"
          f"{max(f.risk for f in rest):.2f}")
    print(f"first 2 frames {t_first:.1f} s, then {len(items) - 2} frames in "
          f"{t_rest:.1f} s = {(len(items) - 2) / t_rest:.1f} frames/s")
    print("timing:", {k: f"{v['mean_ms']:.0f}ms"
                      for k, v in app.timing.summary().items()})
    # the corrected end point improves on odometry (PGO tightens further)
    assert corr_err[-1] < odom_err[-1] + 0.01, (corr_err[-1], odom_err[-1])
    assert sum(f.accepted for f in frames) == len(frames)
    return dict(app=app, frames=frames, vis=vis, odom_err=odom_err,
                corr_err=corr_err, t_rest=t_rest)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    run(args.device)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
