"""The JAX package on the CPU on the port's outdoor card scenes: what the
reference itself gives where the card run's assertions were taken from
other configurations (a script, not collected by pytest).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/outdoor_reference.py kitti
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/outdoor_reference.py accuracy K
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/outdoor_reference.py icp K

`kitti`: `chip_smoke.py`'s KITTI drive (20 scans at 2,048 azimuths,
GPS-grade priors, ground removal) through JAX's `run_kitti_sequence` at
its KITTI default config, and the port's on the CPU: tests/test_eval.py's
error ratio for each. `accuracy K`: the 200-frame regression's drive at its
default config, the port's App on the CPU up to frame K, then frames K and
K + 1 from that state (a checkpoint both packages load) through each
package's App. `icp K`: the port alone on frame K from that state — the
frame's ICP again from the identity, from the true correction, and
without normal-space trim. JAX's App takes ~10 s a KITTI frame and
~20-90 s an accuracy frame on a CPU.
"""
import json
import os
import sys
import tempfile

import numpy as np
import torch


def kitti() -> dict:
    from aicp_mapping_tpu.eval.kitti_runner import run_kitti_sequence as j_run
    from aicp_mapping_tpu_torch.eval.kitti_runner import (drive_errors,
                                                          run_kitti_sequence)
    from aicp_mapping_tpu_torch.tools.urban import write_kitti_drive

    out = {}
    with tempfile.TemporaryDirectory() as d:
        scan_dir, _, gt, priors = write_kitti_drive(d, 20)
        for name, run in (("jax", lambda: j_run(scan_dir, priors=priors,
                                                remove_ground=True)),
                          ("port_cpu", lambda: run_kitti_sequence(
                              scan_dir, priors=priors, remove_ground=True,
                              device="cpu"))):
            traj, results, _ = run()
            out[name] = dict(drive_errors(np.asarray(traj), gt, priors),
                             accepted=sum(r.accepted for r in results))
            print(name, json.dumps(out[name]), flush=True)
    return out


def accuracy(k: int) -> dict:
    from aicp_mapping_tpu.io import checkpoint as jcheckpoint
    from aicp_mapping_tpu.pipeline.sequence import SequenceRunner as JRunner
    from aicp_mapping_tpu_torch.eval.accuracy import accuracy_config
    from aicp_mapping_tpu_torch.io import checkpoint
    from aicp_mapping_tpu_torch.pipeline.app import App
    from aicp_mapping_tpu_torch.pipeline.sequence import SequenceRunner
    from aicp_mapping_tpu_torch.tools.urban import urban_sequence

    items, _ = urban_sequence(n_frames=k + 2, seed=0)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state")
        app = App(accuracy_config(), device="cpu")
        SequenceRunner(app).run_clouds(items[:k])
        checkpoint.save_checkpoint(app, path)
        for name, load, runner in (
                ("port_cpu", lambda: checkpoint.load_checkpoint(
                    path, device="cpu"), SequenceRunner),
                ("jax", lambda: jcheckpoint.load_checkpoint(path), JRunner)):
            resumed = load()
            out[name] = []
            for it in items[k:]:
                f = runner(resumed).run_clouds([it])[0]
                out[name].append(dict(
                    accepted=bool(f.accepted), iterations=int(f.n_iterations),
                    overlap=float(f.octree_overlap),
                    correction_t=np.asarray(f.correction)[:3, 3].tolist()))
            print(name, json.dumps(out[name]), flush=True)
    return out


def icp(k: int) -> dict:
    import dataclasses

    from aicp_mapping_tpu_torch.eval.accuracy import accuracy_config
    from aicp_mapping_tpu_torch.pipeline.app import App
    from aicp_mapping_tpu_torch.pipeline.sequence import SequenceRunner
    from aicp_mapping_tpu_torch.registration.icp import (clamp_trim_ratio,
                                                         point_to_plane_icp)
    from aicp_mapping_tpu_torch.tools.urban import urban_sequence

    items, gt = urban_sequence(n_frames=k + 1, seed=0)
    app = App(accuracy_config(), device="cpu")
    SequenceRunner(app).run_clouds(items[:k])
    calls, step = [], app._app_step

    def recording(*args):
        calls.append((args, step(*args)))
        return calls[-1][1]

    app._app_step = recording
    SequenceRunner(app).run_clouds([items[k]])
    args, out = calls[0]
    truth = torch.as_tensor(gt[k]) @ torch.linalg.inv(args[3] @ args[2])
    cfg = app.cfg
    ratio = clamp_trim_ratio(out.overlap_percent, cfg.trim_ratio_floor,
                             cfg.trim_ratio_ceil)
    icp_args = (out.filtered_points, out.filtered_mask, args[4], args[5],
                args[6])
    res = {"true_t": truth[:3, 3].tolist()}
    for name, init, icp_cfg in (
            ("from_identity", torch.eye(4), cfg.icp),
            ("from_truth", truth, cfg.icp),
            ("no_normal_space_trim", torch.eye(4),
             dataclasses.replace(cfg.icp, trim_normal_space=False))):
        r = point_to_plane_icp(*icp_args, init, ratio, icp_cfg)
        res[name] = r.T[:3, 3].tolist()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    torch.set_num_threads(os.cpu_count() or 1)
    if sys.argv[1] == "kitti":
        kitti()
    elif sys.argv[1] == "icp":
        icp(int(sys.argv[2]))
    else:
        accuracy(int(sys.argv[2]))
