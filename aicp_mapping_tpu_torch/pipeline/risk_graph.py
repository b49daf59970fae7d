"""The risk stage (`pipeline.fused.risk_stage`) as CUDA graphs on the card.

Eagerly the stage is ~460 launches a frame. Its only host reads are the
error checks of its eigen-solves: `torch.linalg.eigh` of each cloud's
cluster covariances and `torch.linalg.eigvalsh` of the matched normals'
second moment (`overlap/alignability.py`). On CUDA the stage is therefore
three captured pieces replayed around those solves, which stay eager:

1. the FOV overlap, both clouds' segmentation (voxel grid, kNN normals,
   the label-propagation kernel, the cluster filter and compaction) and
   their cluster moments (`alignability._cluster_moments`);
   eager: `torch.linalg.eigh` of each cloud's covariances;
2. the boxes (`_cluster_boxes`) and the plane matching up to the second
   moment (`_match_planes`); eager: `torch.linalg.eigvalsh`;
3. the alignability, the classifier and the gate (`classify`).

The pieces are the eager stage's own functions, so both paths give the
same bits. The inputs reach static buffers by `copy_`, in stream order
and with no host wait. Graphs are kept per key (`utils.graphs`: the
configuration, device, thread, stream and the inputs' shapes): a key's
first call runs the eager stage, its second captures. The results are
copies: the App's finalizer reads them after the next frame's replay has
overwritten the graphs' buffers. Spans of the port's tracer:
"aicp.risk.align" around the loads, replays and solves, as around the
eager alignability; "aicp.risk.replay", one a replay.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from ..classification.classifier import SVMModel
from ..overlap.alignability import (AlignOptions, _alignability,
                                    _cluster_boxes, _cluster_moments,
                                    _match_planes, _segment_cloud)
from ..overlap.fov import fov_overlap
from ..utils import graphs
from ..utils.timing import span

_graphs: collections.OrderedDict = collections.OrderedDict()
graphs.register("risk", "captures", "replays", "eager_calls")


def capture_plan(device) -> bool:
    """Whether the stage replays captured pieces: on CUDA."""
    return torch.device(device).type == "cuda"


def align_options(cfg) -> AlignOptions:
    return AlignOptions(voxel_size=cfg.voxel_size,
                        ds_capacity=cfg.align_ds_capacity,
                        max_clusters=cfg.align_max_clusters)


def classify(cfg, fov, overlap, align, model: SVMModel | None):
    """(P(failure) on (overlap, alignability), -1 without a model;
    risk_ok = risk <= risk_threshold)."""
    risk = torch.full_like(fov, -1.0)
    if model is not None:
        risk = model.predict_probability(torch.stack([overlap, align]))
    return risk, risk <= float(cfg.risk_threshold)


def _model_tensors(model: SVMModel | None) -> list:
    return ([] if model is None else
            [getattr(model, f.name) for f in dataclasses.fields(model)])


def graph_key(cfg, inputs, model) -> tuple:
    config = (align_options(cfg), float(cfg.sensor_range),
              float(cfg.sensor_angular_view), float(cfg.risk_threshold),
              model is None)
    return graphs.key(config, list(inputs) + _model_tensors(model),
                      inputs[3].device)


def graph_for(key, cfg, inputs, model):
    """The captured stage of `key`, or None on the key's first call
    (`utils.graphs.lookup`)."""
    def make():
        rep = _Replay(cfg, inputs, model)
        rep.load(inputs, model)
        rep.capture()
        return rep

    return graphs.lookup(_graphs, key, make)


def warmed(key) -> None:
    graphs.warmed(_graphs, key)


class _Replay:
    """The stage's static inputs (ref_points, ref_mask, ref_pose, fpts,
    fmask, read_pose, overlap and the classifier's tensors), its three
    pieces and the static results of the solves between them. A replay
    overwrites the pieces' results in place."""

    def __init__(self, cfg, inputs, model):
        def like(t):
            return torch.empty(t.shape, dtype=t.dtype, device=t.device)

        self.cfg, self.o = cfg, align_options(cfg)
        self.inputs = [like(t) for t in inputs]
        self.model = (None if model is None else
                      SVMModel(*map(like, _model_tensors(model))))
        fpts = inputs[3]
        C = self.o.max_clusters
        self.evecs = torch.empty((2, C, 3, 3), dtype=fpts.dtype,
                                 device=fpts.device)
        self.evals = torch.empty(3, dtype=fpts.dtype, device=fpts.device)
        self.graphs = []

    def load(self, inputs, model) -> None:
        """A call's inputs into the static buffers: no host read, no host
        wait."""
        for dst, src in zip(self.inputs + _model_tensors(self.model),
                            list(inputs) + _model_tensors(model)):
            dst.copy_(src)

    def segment(self) -> None:
        """Piece 1: FOV overlap, both clouds' segmentation and moments."""
        ref_points, ref_mask, ref_pose, fpts, fmask, read_pose, _ = \
            self.inputs
        self.fov, a_in_b, b_in_a = fov_overlap(
            ref_points, ref_mask, ref_pose, fpts, fmask, read_pose,
            self.cfg.sensor_range, self.cfg.sensor_angular_view)
        self.planes = (_segment_cloud(ref_points, a_in_b, ref_pose, self.o),
                       _segment_cloud(fpts, b_in_a, read_pose, self.o))
        self.moments = [_cluster_moments(p.points, p.normals, p.labels,
                                         self.o.max_clusters)
                        for p in self.planes]

    def solve_boxes(self) -> None:
        """Eager: each cloud's `eigh`, as `_cluster_stats` calls it."""
        for m, evecs in zip(self.moments, self.evecs):
            evecs.copy_(torch.linalg.eigh(m.cov)[1])

    def match(self) -> None:
        """Piece 2: the boxes and the plane matching up to `m2`."""
        a, b = self.planes
        stats = [_cluster_boxes(m, evecs, self.o.max_clusters)
                 for m, evecs in zip(self.moments, self.evecs)]
        self.m2, self.diagnostics = _match_planes(a, stats[0], b, stats[1],
                                                  self.o)

    def solve_pca(self) -> None:
        """Eager: `eigvalsh` of the matched normals' second moment."""
        self.evals.copy_(torch.linalg.eigvalsh(self.m2))

    def gate(self) -> None:
        """Piece 3: the alignability, the classifier and the gate."""
        align = _alignability(self.evals,
                              self.diagnostics["n_matched_points"])
        risk, risk_ok = classify(self.cfg, self.fov, self.inputs[6], align,
                                 self.model)
        self.out = (self.fov, align, risk, risk_ok)

    def pieces(self):
        return ((self.segment, self.solve_boxes),
                (self.match, self.solve_pca), (self.gate, None))

    def capture(self) -> None:
        """Each piece as a CUDA graph (`utils.graphs.capture`), replayed
        once and its solve run, so that the next piece's warm-up reads
        sound values."""
        dev = self.inputs[3].device
        for body, solve in self.pieces():
            self.graphs.append(graphs.capture(body, dev))
            self.graphs[-1].replay()
            if solve is not None:
                solve()
        graphs.count("risk", "captures")

    def run(self, inputs, model):
        """The stage by replays: (fov, alignability, risk, risk_ok), 0-d
        copies."""
        with span("aicp.risk.align"):
            self.load(inputs, model)
            for graph, (_, solve) in zip(self.graphs, self.pieces()):
                with span("aicp.risk.replay"):
                    graph.replay()
                graphs.count("risk", "replays")
                if solve is not None:
                    solve()
        return tuple(t.clone() for t in self.out)
