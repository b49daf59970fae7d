"""Alignment-risk classifier, (octree overlap, alignability) -> P(failure):
PyTorch port of `aicp_mapping_tpu.classification.classifier`.

A degree-3 polynomial-kernel SVM on the two features is a linear model in
the 10 monomials of `poly3_features`; P(failure) = sigmoid(decision).
Models are the JAX package's `.npz` files (`w`, `b`, `mean`, `std`,
`threshold`); `data/classification/risk_classifier.npz` is the shipped one.
`RiskClassifier.train` fits the model as JAX's `_train` does: momentum
subgradient descent on the class-balanced hinge loss with an L2 term, on
the classifier's device (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def poly3_features(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (..., 10) monomial embedding of a degree-3 poly kernel."""
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([torch.ones_like(x1), x1, x2, x1 * x1, x1 * x2,
                        x2 * x2, x1 * x1 * x1, x1 * x1 * x2, x1 * x2 * x2,
                        x2 * x2 * x2], dim=-1)


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


def _dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in float64 (each f32 product exact) and rounded to
    float32 once, so the card and the CPU give the same bits."""
    return (a.double() @ b.double()).float()


def hinge_gradient(phi: torch.Tensor, s: torch.Tensor, ct_h: torch.Tensor,
                   w: torch.Tensor, b: torch.Tensor, l2: float):
    """(d/dw, d/db) of mean(sw * max(0, 1 - s * (phi @ w + b))) + l2 |w|^2
    given ct_h = sw / n, the subgradient `jax.grad` takes: max(0, x) has
    slope 1 above 0, 0 below, and 1/2 at a tie (JAX's rule for
    `maximum`)."""
    x = 1.0 - s * (_dot64(phi, w) + b)
    slope = torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0))
    ct = s * -(ct_h * slope)
    return _dot64(ct, phi) + (l2 * w + l2 * w), ct.double().sum().float()


def _train(z: torch.Tensor, y: torch.Tensor, steps: int = 4000,
           lr: float = 0.05, l2: float = 1e-3):
    """(w (10,), b ()) of the hinge-loss SVM on standardized features `z`
    (n, 2) and labels `y` {0, 1}: full-batch momentum (0.9) subgradient
    descent from zero, with class-balanced sample weights (failure sets are
    small). The descent is sensitive to rounding (a hinge kink crossed one
    step apart parts two runs), so its reductions are float64 rounded
    once: the same bits on every device."""
    phi = poly3_features(z)
    s = 2.0 * y - 1.0
    n = torch.full((), float(phi.shape[0]), device=z.device)
    pos = torch.clamp(y.double().sum().float(), min=1.0)
    neg = torch.clamp(n - y.double().sum().float(), min=1.0)
    sw = torch.where(y > 0.5, n / (pos * 2.0), n / (neg * 2.0))
    ct_h = sw * (1.0 / n)
    w = torch.zeros(10, dtype=torch.float32, device=z.device)
    b = torch.zeros((), dtype=torch.float32, device=z.device)
    mw, mb = torch.zeros_like(w), torch.zeros_like(b)
    for _ in range(steps):
        gw, gb = hinge_gradient(phi, s, ct_h, w, b, l2)
        mw = mw * 0.9 + gw
        mb = mb * 0.9 + gb
        w = w - mw * lr
        b = b - mb * lr
    return w, b


class RiskClassifier:
    """train / test / save / load of the JAX package's classifier API;
    `device` is where `train` runs (testing runs on the CPU)."""

    def __init__(self, threshold: float = 0.50, device="cuda"):
        self.threshold = threshold
        self.device = device
        self.model: SVMModel | None = None

    def train(self, features, labels, steps: int = 4000) -> None:
        from ..pipeline.app import check_device

        dev = check_device(self.device, "RiskClassifier.train")
        x = torch.as_tensor(np.asarray(features, np.float32).reshape(-1, 2),
                            device=dev)
        y = torch.as_tensor(np.asarray(labels, np.float32).reshape(-1),
                            device=dev)
        x64 = x.double()
        mean = x64.mean(0)
        std = torch.clamp(((x64 - mean) ** 2).mean(0).sqrt().float(),
                          min=1e-6)
        mean = mean.float()
        w, b = _train((x - mean) / std, y, steps=steps)
        self.model = SVMModel(w=w, b=b, mean=mean, std=std)

    def test(self, features, labels=None):
        """Probabilities (N,) on the CPU; with labels also the confusion
        counts and accuracy."""
        assert self.model is not None, "train() or load() first"
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
