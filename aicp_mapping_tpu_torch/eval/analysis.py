"""Offline analysis — the reference's Python scripts and notebooks as a
library; a numpy copy of `aicp_mapping_tpu.eval.analysis`.

Covers: classifier ROC/AUC and F-score ("ROC Curve and F-Score.ipynb"),
confusion-matrix statistics (aicp_classification/common.hpp:10-35),
translation/rotation error vs. ground truth
(python/compute_transl_rot_errors.py), correction-magnitude statistics
(python/traj_correction_magnitude.py), and the accuracy-vs-overlap matrix
("Accuracy vs Overlap.ipynb": a pair is "accurate" when its translation
error is below 2 cm).
"""
from __future__ import annotations

import numpy as np

# numpy 2 renamed `trapz`; the port runs on either
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


# ------------------------------------------------------------- classifier

def confusion_stats(probs: np.ndarray, labels: np.ndarray,
                    threshold: float = 0.5) -> dict:
    """Confusion matrix + derived rates, matching the reference's
    `classification::common.hpp:10-35` accounting (prediction = risk >
    threshold, positive class = alignment failure)."""
    pred = np.asarray(probs).reshape(-1) > threshold
    truth = np.asarray(labels).reshape(-1) > 0.5
    tp = int(np.sum(pred & truth))
    tn = int(np.sum(~pred & ~truth))
    fp = int(np.sum(pred & ~truth))
    fn = int(np.sum(~pred & truth))
    n = max(tp + tn + fp + fn, 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {
        "tp": tp, "tn": tn, "fp": fp, "fn": fn,
        "accuracy": (tp + tn) / n,
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / max(precision + recall, 1e-12),
    }


def roc_curve(probs: np.ndarray, labels: np.ndarray,
              n_thresholds: int = 101):
    """Returns (auc, tpr, fpr) over evenly spaced thresholds."""
    probs = np.asarray(probs).reshape(-1)
    truth = np.asarray(labels).reshape(-1) > 0.5
    n_pos = max(int(truth.sum()), 1)
    n_neg = max(int((~truth).sum()), 1)
    ts = np.linspace(0, 1, n_thresholds)
    tpr = np.array([np.sum((probs > t) & truth) / n_pos for t in ts])
    fpr = np.array([np.sum((probs > t) & ~truth) / n_neg for t in ts])
    # integrate TPR over FPR (fpr is decreasing in t)
    auc = float(_trapezoid(tpr[::-1], fpr[::-1]))
    return auc, tpr, fpr


def f_scores(probs: np.ndarray, labels: np.ndarray,
             n_thresholds: int = 101):
    """F1 at each threshold; returns (best_threshold, best_f1, thresholds,
    scores) — the F-score sweep of the reference notebook."""
    ts = np.linspace(0, 1, n_thresholds)
    scores = np.array([confusion_stats(probs, labels, t)["f1"] for t in ts])
    best = int(np.argmax(scores))
    return float(ts[best]), float(scores[best]), ts, scores


# ------------------------------------------------------------ trajectories

def pose_errors(poses_gt: np.ndarray, poses_est: np.ndarray) -> dict:
    """Per-frame translation/rotation error vs. ground truth
    (compute_transl_rot_errors.py semantics: direct frame-wise deltas)."""
    n = min(len(poses_gt), len(poses_est))
    t_err = np.zeros(n)
    r_err = np.zeros(n)
    for i in range(n):
        E = np.linalg.inv(poses_gt[i]) @ poses_est[i]
        t_err[i] = np.linalg.norm(E[:3, 3])
        c = (np.trace(E[:3, :3]) - 1.0) / 2.0
        r_err[i] = np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))
    return {
        "t_err_mean": float(t_err.mean()) if n else 0.0,
        "t_err_median": float(np.median(t_err)) if n else 0.0,
        "t_err_max": float(t_err.max()) if n else 0.0,
        "r_err_deg_mean": float(r_err.mean()) if n else 0.0,
        "r_err_deg_median": float(np.median(r_err)) if n else 0.0,
        "r_err_deg_max": float(r_err.max()) if n else 0.0,
        "t_err": t_err, "r_err_deg": r_err,
    }


def correction_magnitudes(corrections: np.ndarray) -> dict:
    """Statistics of per-frame correction transforms
    (traj_correction_magnitude.py): translation norm and rotation angle of
    each 4x4 correction."""
    corrections = np.asarray(corrections).reshape(-1, 4, 4)
    t = np.linalg.norm(corrections[:, :3, 3], axis=1)
    c = np.clip((np.trace(corrections[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                -1.0, 1.0)
    r = np.degrees(np.arccos(c))
    return {
        "n": len(corrections),
        "t_mean": float(t.mean()) if len(t) else 0.0,
        "t_max": float(t.max()) if len(t) else 0.0,
        "t_rms": float(np.sqrt(np.mean(t ** 2))) if len(t) else 0.0,
        "r_deg_mean": float(r.mean()) if len(r) else 0.0,
        "r_deg_max": float(r.max()) if len(r) else 0.0,
    }


def accuracy_vs_overlap(overlaps: np.ndarray, t_errors: np.ndarray,
                        accurate_below: float = 0.02,
                        bins=(0, 20, 40, 60, 80, 100)) -> dict:
    """Fraction of accurate registrations per overlap bin
    ("Accuracy vs Overlap.ipynb": accurate = translation error <= 2 cm)."""
    overlaps = np.asarray(overlaps).reshape(-1)
    acc = np.asarray(t_errors).reshape(-1) <= accurate_below
    edges = np.asarray(bins, np.float64)
    out = {"bins": [], "accuracy": [], "count": []}
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (overlaps >= lo) & (overlaps < hi)
        out["bins"].append((float(lo), float(hi)))
        out["count"].append(int(sel.sum()))
        out["accuracy"].append(float(acc[sel].mean()) if sel.any() else float("nan"))
    return out


def overlap_matrix(frames) -> np.ndarray:
    """N x N octree-overlap matrix from FrameResult-like records of batch
    pairwise experiments ("Overlap Maps.ipynb" input,
    registration_main.cpp:503-515 compare_results)."""
    ids = sorted({f.reading_id for f in frames} |
                 {f.reference_id for f in frames})
    index = {v: i for i, v in enumerate(ids)}
    M = np.full((len(ids), len(ids)), np.nan)
    for f in frames:
        M[index[f.reference_id], index[f.reading_id]] = f.octree_overlap
    return M


def risk_vs_degeneracy(risks: np.ndarray, degeneracies: np.ndarray,
                       t_errors: np.ndarray,
                       error_thresh: float = 0.02) -> dict:
    """Compare the two failure predictors against actual outcome — the
    "Alignment Risk vs. Degeneracy" notebook analog (python/*.ipynb).

    Labels each pair as failed (t_error > error_thresh) and reports, per
    predictor, the AUC of predicting failure plus the Pearson correlation
    between the predictors. Degeneracy predicts failure when LOW, so its
    score is negated for the AUC.
    """
    risks = np.asarray(risks, np.float64)
    deg = np.asarray(degeneracies, np.float64)
    terr = np.asarray(t_errors, np.float64)
    ok = np.isfinite(risks) & np.isfinite(deg) & np.isfinite(terr)
    risks, deg, terr = risks[ok], deg[ok], terr[ok]
    labels = (terr > error_thresh).astype(np.int32)
    out = {"n": int(len(labels)), "n_failed": int(labels.sum())}
    if labels.sum() in (0, len(labels)):
        out["risk_auc"] = out["degeneracy_auc"] = float("nan")
    else:
        def norm01(x):  # roc_curve thresholds span [0, 1]
            lo, hi = x.min(), x.max()
            return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)

        auc_r, _, _ = roc_curve(norm01(risks), labels)
        auc_d, _, _ = roc_curve(norm01(-deg), labels)
        out["risk_auc"] = auc_r
        out["degeneracy_auc"] = auc_d
    if len(labels) > 1 and risks.std() > 0 and deg.std() > 0:
        out["correlation"] = float(np.corrcoef(risks, deg)[0, 1])
    else:
        out["correlation"] = float("nan")
    return out
