"""SE(3) / SO(3) math, PyTorch port of `aicp_mapping_tpu.geometry.se3`.

Transforms are 4x4 homogeneous float32 matrices; twists are [v, w]. Every
function works on the device of its inputs and broadcasts over leading
batch dimensions like its JAX twin.
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def make_transform(rotation: torch.Tensor,
                   translation: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(rotation.shape[:-2], translation.shape[:-1])
    rotation = rotation.expand(batch + (3, 3))
    translation = translation.expand(batch + (3,))
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=rotation.dtype,
                         device=rotation.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse via R^T (no general 4x4 inversion)."""
    Rt = rotation(T).transpose(-1, -2)
    return make_transform(Rt, -torch.einsum("...ij,...j->...i", Rt,
                                            translation(T)))


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) transform to (..., 3) points."""
    return points @ rotation(T).T + translation(T)


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    return vecs @ rotation(T).T


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _eye3_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3). Taylor-safe near zero."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    K = skew(w)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    return _eye3_like(K) + A * K + B * (K @ K)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z), w >= 0
    (branch-free Shepperd's method, as in the JAX twin)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                         dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)            # (..., 4, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) rotation vector; Taylor-safe."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    w_skew = 0.5 * (R - R.transpose(-1, -2))
    vec = torch.stack([w_skew[..., 2, 1], w_skew[..., 0, 2],
                       w_skew[..., 1, 0]], dim=-1)
    th = theta[..., None]
    sin_t = torch.sin(th)
    scale = torch.where(
        th < 1e-4, 1.0 + th ** 2 / 6.0,
        th / torch.where(torch.abs(sin_t) < _EPS, 1.0, sin_t))
    w = vec * scale
    # Near theta = pi the antisymmetric part vanishes: quaternion route.
    qv = matrix_to_quat(R)[..., 1:4]
    qn = torch.clamp(torch.linalg.norm(qv, dim=-1, keepdim=True), min=_EPS)
    return torch.where(th > 3.0, qv / qn * th, w)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (..., 6) [v, w] -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    K = skew(w)
    small = theta2 < 1e-8
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    V = _eye3_like(K) + B * K + C * (K @ K)
    return make_transform(R, torch.einsum("...ij,...j->...i", V, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> twist (..., 6) [v, w]."""
    w = so3_log(rotation(T))
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    K = skew(w)
    # Small-angle cutoff sized for f32: below theta^2 ~ 1.2e-7, 1 - cos
    # underflows to 0 and the closed form turns inf/NaN.
    small = theta2 < 1e-6
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * torch.clamp(B, min=_EPS)))
        / torch.clamp(theta2, min=_EPS))
    Vinv = _eye3_like(K) - 0.5 * K + coef * (K @ K)
    v = torch.einsum("...ij,...j->...i", Vinv, translation(T))
    return torch.cat([v, w], dim=-1)
