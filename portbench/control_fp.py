"""The readings the limits of a cell with failure prediction on are set
from, on the card, where `control.py` cannot take them: its control
chain has no risk stage.

    python3 portbench/control_fp.py --workload <cell> --side risky \
        --seeds <n> ... [--seconds 5]
    python3 portbench/control_fp.py --workload <cell> --side control \
        --seeds <n> ... [--frames 40] [--precision tf32]

`--side risky` runs the cell (`harness.run_cell`) once per seed in this
one process with the program's risk stage calling every frame risky, and
prints each seed's compared numbers. `--side control` puts the reference
in the program's place, computed in the precision below the
configuration's (TF32 matmuls: `--precision tf32`; `fp32` lowers nothing
and must read nothing), runs `--frames` frames of the cell's scene
through it on its own schedule of references, risk-gated frames
included, and judges them by the same comparison against the reference
at the configuration's precision: the upper readings. The lower readings
and the fault's are `control.py --side program` and `--side fault` on
the same cell. One JSON line per seed. The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_frames(config: dict, seed: int, frames: int, sample: list,
                   start: int, device):
    """The reference as the system: `frames` frames of the scene through
    `FramePath` and `RiskPath` on their own chain of references, collected
    as `check_fp.judge` takes them."""
    from portbench import check, check_fp
    from portbench.drivers import make_scene
    from portbench.reference import plain
    from portbench.reference.frame import FramePath, graph_index
    from portbench.reference.risk import RiskPath

    freq = int(config["pipeline"]["reference_update_frequency"])
    scene = make_scene(config, seed, device)
    supply = [scene.frame(i) for i in range(frames)]
    path, risk_path = FramePath(config, device), RiskPath(config, device)
    eye = np.eye(4, dtype=np.float32)
    prior0 = np.asarray(supply[0][2], np.float32)
    pre = {0: path.prefilter(*supply[0][1:])}
    accepted, gated = [True], [False]
    corr, pose = {0: None}, {0: plain.repin_roll_pitch_np(prior0, prior0)}
    p0 = pre[0]
    results = {0: check.Judged(eye, True, pose[0], -1.0, 0,
                               p0.points[p0.mask].cpu().numpy())}
    risk = {0: (-1.0, -1.0, -1.0, False)}
    for k in range(1, frames):
        _, pts, prior = supply[k]
        pre[k] = f = path.prefilter(pts, prior)
        r = check_fp.reference_schedule(accepted + [True], gated + [False],
                                        freq)[k]
        ref = path.reference_cloud(pre[r], corr[r])
        out = path.register(f, prior, *ref)
        rk = risk_path.stage(ref[0], ref[2], pose[r], f.points, f.mask,
                             prior, out.overlap)
        o = check_fp.Outcome(out, rk, rk.gated, False, prior)
        accepted.append(o.accepted)
        gated.append(o.gated)
        corr[k], pose[k] = o.applied, o.corrected_pose
        results[k] = check.Judged(
            o.applied if o.accepted else out.correction, o.accepted,
            o.corrected_pose, out.overlap, graph_index(accepted)[r],
            o.aligned_points[f.mask].cpu().numpy() if o.accepted else None,
            0 if o.gated else out.n_iterations)
        risk[k] = (rk.fov, rk.alignability, rk.risk, not o.gated)
    return check_fp.Collected(
        supply=supply, truth=[scene.true_pose(i) for i in range(frames)],
        results=results,
        frames=check_fp.frames_to_judge(accepted, gated, freq, sample,
                                        start),
        start=start, risk=risk)


def every_frame_risky(risk_stage):
    """`fused.risk_stage` calling every frame risky: P(failure) 1, the
    gate shut."""
    import torch

    def risky(*args, **kwargs):
        fov, align, _, _ = risk_stage(*args, **kwargs)
        return (fov, align, torch.ones_like(fov),
                torch.zeros((), dtype=torch.bool, device=fov.device))

    return risky


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("risky", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--precision", choices=("tf32", "fp32"), default="tf32")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import check, check_fp, harness, spec

    cell = spec.load_cell(ROOT, args.workload)
    work = cell.workload["check"]
    if args.side == "risky":
        from aicp_mapping_tpu_torch.pipeline import fused

        fused.risk_stage = every_frame_risky(fused.risk_stage)
    for seed in args.seeds:
        if args.side == "risky":
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
        torch.backends.cudnn.allow_tf32 = args.precision == "tf32"
        collected = control_frames(
            cell.config, seed, args.frames, sample,
            min(work["start_frames"], args.frames - 1), "cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        got = check_fp.judge(cell.config, collected, "cuda")
        correct, _ = check.verdict(got["numbers"], cell.workload["limits"])
        print(json.dumps(dict(cell=cell.name, side="control",
                              precision=args.precision, seed=seed,
                              correct=correct, numbers=got["numbers"])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
