"""The readings the check's limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --side program \
        --seeds <n> ... [--seconds 5]
    python3 portbench/control.py --workload <cell> --side fault \
        --seeds <n> ... [--seconds 5]
    python3 portbench/control.py --workload <cell> --side control \
        --seeds <n> ... [--frames 40] [--precision tf32]

`--side program` runs the cell (its timed path, `harness.run_cell`) once
per seed in this one process and prints each seed's compared numbers: the
lower readings. `--side fault` does the same with the frame step's ICP
handing back the transform it started from (a step that returns its
state unchanged: every frame keeps its prior). `--side control` puts the
reference in the program's place, computed in the precision below the
configuration's (float32 with TF32 off, so TF32 matmuls: `--precision
tf32`), runs `--frames` frames of the cell's scene through it with the
App's own schedule of references, and judges them by the same comparison
against the reference at the configuration's precision: the upper
readings. `--precision fp32` runs the same with nothing lowered, which
must read nothing. One JSON line per seed. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_frames(config: dict, pipelined: bool, seed: int, frames: int,
                   sample: list, start: int, device):
    """The reference as the system: `frames` frames of the scene through
    `reference.frame.FramePath` on its own chain of references, collected
    as `check.judge` takes them."""
    from portbench import check
    from portbench.drivers import make_scene
    from portbench.reference.frame import (FramePath, graph_index,
                                           reference_schedule)

    freq = int(config["pipeline"]["reference_update_frequency"])
    scene = make_scene(config, seed, device)
    supply = [scene.frame(i) for i in range(frames)]
    path = FramePath(config, device)
    eye = np.eye(4, dtype=np.float32)
    pre = {0: path.prefilter(*supply[0][1:])}
    accepted, corr, results = [True], {0: None}, {}
    p0 = pre[0]
    results[0] = check.Judged(eye, True, supply[0][2], -1.0, 0,
                              p0.points[p0.mask].cpu().numpy())
    for k in range(1, frames):
        _, pts, prior = supply[k]
        pre[k] = path.prefilter(pts, prior)
        r = reference_schedule(accepted + [True], freq, pipelined)[k]
        ref = path.reference_cloud(pre[r], corr[r])
        out = path.register(pre[k], prior, *ref)
        accepted.append(out.accepted)
        corr[k] = out.correction if out.accepted else eye
        aligned = (out.aligned_points[pre[k].mask].cpu().numpy()
                   if out.accepted else None)
        results[k] = check.Judged(out.correction, out.accepted,
                                  out.corrected_pose, out.overlap,
                                  graph_index(accepted)[r], aligned,
                                  out.n_iterations)
    return check.Collected(
        supply=supply, truth=[scene.true_pose(i) for i in range(frames)],
        results=results,
        frames=check.frames_to_judge(accepted, freq, pipelined, sample,
                                     start),
        start=start)


def _state_unchanged():
    """The frame step's ICP hands back the transform it started from."""
    from aicp_mapping_tpu_torch.pipeline import fused

    real = fused.point_to_plane_icp

    def unchanged(*args, **kwargs):
        return dataclasses.replace(real(*args, **kwargs), T=args[5])

    fused.point_to_plane_icp = unchanged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "fault", "control"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--precision", choices=("tf32", "fp32"), default="tf32")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import check, drivers, harness, spec

    cell = spec.load_cell(ROOT, args.workload)
    work = cell.workload["check"]
    entry = drivers.load_module("entries", cell.traffic["entry"])
    if args.side == "fault":
        _state_unchanged()
    for seed in args.seeds:
        if args.side != "control":
            out = harness.run_cell(cell, seed, args.seconds, False,
                                   device="cuda",
                                   log=lambda m: print(m, file=sys.stderr))
            row = {k: v["value"] for k, v in out["check"].items()}
            print(json.dumps(dict(cell=cell.name, side=args.side, seed=seed,
                                  correct=out["correct"], numbers=row)),
                  flush=True)
            continue
        frames = list(range(1, args.frames))
        sample = harness._sample(frames, work["sample_frames"], seed)
        torch.backends.cuda.matmul.allow_tf32 = args.precision == "tf32"
        collected = control_frames(
            cell.config, entry.Driver.pipelined, seed, args.frames, sample,
            min(work["start_frames"], args.frames - 1), "cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        got = entry.judge(cell.config, collected, "cuda")
        correct, table = check.verdict(got["numbers"],
                                       cell.workload["limits"])
        print(json.dumps(dict(cell=cell.name, side="control",
                              precision=args.precision, seed=seed,
                              correct=correct, numbers=got["numbers"])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
