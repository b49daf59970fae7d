"""Alignment-risk classifier, (octree overlap, alignability) -> P(failure):
PyTorch port of `aicp_mapping_tpu.classification.classifier`.

A degree-3 polynomial-kernel SVM on the two features is a linear model in
the 10 monomials of `poly3_features`; P(failure) = sigmoid(decision).
Models are the JAX package's `.npz` files (`w`, `b`, `mean`, `std`,
`threshold`); `data/classification/risk_classifier.npz` is the shipped one.
Training is not ported (ROADMAP Q1 #14): `RiskClassifier.train` raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def poly3_features(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (..., 10) monomial embedding of a degree-3 poly kernel."""
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([torch.ones_like(x1), x1, x2, x1 * x1, x1 * x2,
                        x2 * x2, x1 ** 3, x1 * x1 * x2, x1 * x2 * x2,
                        x2 ** 3], dim=-1)


@dataclasses.dataclass(frozen=True)
class SVMModel:
    w: torch.Tensor      # (10,)
    b: torch.Tensor      # ()
    mean: torch.Tensor   # (2,) feature standardization
    std: torch.Tensor    # (2,)

    def to(self, device) -> "SVMModel":
        return SVMModel(*(t.to(device) for t in dataclasses.astuple(self)))

    def decision(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.mean) / self.std
        return poly3_features(z) @ self.w + self.b

    def predict_probability(self, x: torch.Tensor) -> torch.Tensor:
        """P(alignment failure) in [0, 1]; >= threshold means high risk."""
        return torch.sigmoid(self.decision(x))


class RiskClassifier:
    """test / save / load of the JAX package's classifier API."""

    def __init__(self, threshold: float = 0.50):
        self.threshold = threshold
        self.model: SVMModel | None = None

    def train(self, features, labels, steps: int = 4000) -> None:
        raise NotImplementedError(
            "RiskClassifier.train: training and the classifier CLI are "
            "ROADMAP Q1 #14; load a model trained by the JAX package")

    def test(self, features, labels=None):
        """Probabilities (N,) on the CPU; with labels also the confusion
        counts and accuracy."""
        assert self.model is not None, "load() first"
        x = torch.as_tensor(np.asarray(features, np.float32).reshape(-1, 2))
        probs = self.model.to("cpu").predict_probability(x)
        if labels is None:
            return probs
        pred = probs.numpy() >= self.threshold
        lab = np.asarray(labels).reshape(-1) > 0.5
        stats = {"tp": int(np.sum(pred & lab)), "fp": int(np.sum(pred & ~lab)),
                 "tn": int(np.sum(~pred & ~lab)),
                 "fn": int(np.sum(~pred & lab))}
        stats["accuracy"] = (stats["tp"] + stats["tn"]) / max(len(lab), 1)
        return probs, stats

    def save(self, path: str) -> None:
        assert self.model is not None
        np.savez(path, **{k: t.cpu().numpy() for k, t in
                          dataclasses.asdict(self.model).items()},
                 threshold=self.threshold)

    def load(self, path: str) -> None:
        d = np.load(path if path.endswith(".npz") else path + ".npz")
        self.model = SVMModel(*(torch.as_tensor(np.asarray(d[k], np.float32))
                                for k in ("w", "b", "mean", "std")))
        self.threshold = float(d["threshold"])


def load_label_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """The labelled dataset format `id overlap alignability label` per line;
    alignability is stored in [0, 1] and scaled to the runtime's 0-100."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                rows.append((float(parts[1]), float(parts[2]),
                             float(parts[3])))
    arr = np.asarray(rows, dtype=np.float32)
    if arr.size == 0:
        return np.zeros((0, 2), np.float32), np.zeros((0,), np.float32)
    features = arr[:, :2].copy()
    features[:, 1] *= 100.0
    return features, arr[:, 2]
