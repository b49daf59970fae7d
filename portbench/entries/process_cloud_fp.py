"""The closed loop with failure prediction on: `process_cloud`'s client,
one cloud at a time through the wire and `App.process_cloud`, whose check
also keeps each frame's FOV overlap, alignability, P(failure) and whether
the App registered it, and picks the frames to judge on the schedule of
references that risk-gated frames force. `check_fp.judge` compares them
with the plain reference.
"""
from __future__ import annotations

from portbench import check, check_fp
from portbench.entries import process_cloud

judge = check_fp.judge


class Driver(process_cloud.Driver):
    def collect(self, sample: list, start: int):
        results = self.app.frames
        accepted = [r.accepted for r in results]
        gated = check_fp.gated_flags(accepted,
                                     [r.registered for r in results])
        frames = check_fp.frames_to_judge(
            accepted, gated, self.cfg.reference_update_frequency, sample,
            start)
        n = len(results)
        return check_fp.Collected(
            supply=self.supply[:n],
            truth=[self.scene.true_pose(i) for i in range(n)],
            results=check.judged_from_app(self.app, frames),
            frames=frames, start=start,
            risk={k: (float(r.fov_overlap), float(r.alignability),
                      float(r.risk), bool(r.registered))
                  for k, r in enumerate(results)})
