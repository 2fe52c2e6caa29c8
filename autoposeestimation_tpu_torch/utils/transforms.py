"""Rigid-transform algebra on tensors (port of
`autoposeestimation_tpu/utils/transforms.py`, the functions the pose path,
the reconstruction and the robot frame use). Quaternions are (w, x, y, z),
euler angles static-frame XYZ ('sxyz'), rotation vectors axis * angle;
every function takes arbitrary leading batch dimensions."""
from __future__ import annotations

from typing import Optional

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) (..., 4) to unit length."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (..., 4) -> rotation matrix (..., 3, 3). Normalizes with
    a 1e-3 floor, as the JAX version does (bounds the 1/||q|| gradient of
    unnormalized network quaternions)."""
    q = quat_normalize(q, eps=1e-3)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
                     2.0 * (w * y + x * z)], dim=-1),
        torch.stack([2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
                     2.0 * (y * z - w * x)], dim=-1),
        torch.stack([2.0 * (x * z - w * y), 2.0 * (w * x + y * z),
                     1.0 - 2.0 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), branch-free
    Shepperd selection, canonical sign w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def cand(vals, t):
        return torch.stack(vals, dim=-1) / (
            2.0 * torch.sqrt(torch.clamp(t, min=1e-24)))[..., None]

    qs = torch.stack([
        cand([tw, m21 - m12, m02 - m20, m10 - m01], tw),
        cand([m21 - m12, tx, m01 + m10, m02 + m20], tx),
        cand([m02 - m20, m01 + m10, ty, m12 + m21], ty),
        cand([m10 - m01, m02 + m20, m12 + m21, tz], tz),
    ], dim=-2)                                       # (..., 4, 4)
    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    q = torch.gather(qs, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    sign = torch.where(q[..., :1] < 0.0, -1.0, 1.0)
    return quat_normalize(q * sign)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (..., 4)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) -> (w, -x, -y, -z)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def axangle_to_mat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> rotation matrix (..., 3, 3); `axis` (..., 3) need not
    be unit length."""
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
    x, y, z = axis.unbind(-1)
    c, s = torch.cos(angle), torch.sin(angle)
    cc = 1.0 - c
    rows = [
        torch.stack([x * x * cc + c, x * y * cc - z * s,
                     x * z * cc + y * s], dim=-1),
        torch.stack([y * x * cc + z * s, y * y * cc + c,
                     y * z * cc - x * s], dim=-1),
        torch.stack([z * x * cc - y * s, z * y * cc + x * s,
                     z * z * cc + c], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rotvec_to_mat(rv: torch.Tensor) -> torch.Tensor:
    """Rotation vector (axis * angle, (..., 3)), the robot's pose
    convention -> rotation matrix; the identity at angle 0."""
    angle = torch.linalg.vector_norm(rv, dim=-1)
    x_axis = torch.zeros_like(rv)
    x_axis[..., 0] = 1.0
    return axangle_to_mat(torch.where(angle[..., None] > 1e-12, rv, x_axis),
                          angle)


def mat_to_rotvec(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector (axis * angle); below an angle of
    1e-7 the vector is 2 (x, y, z) of the quaternion."""
    q = mat_to_quat(m)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    sin_half = torch.sqrt(torch.clamp(1.0 - w * w, min=1e-24))
    axis = q[..., 1:] / sin_half[..., None]
    return torch.where(angle[..., None] > 1e-7, axis * angle[..., None],
                       q[..., 1:] * 2.0)


def euler_to_mat(ai: torch.Tensor, aj: torch.Tensor,
                 ak: torch.Tensor) -> torch.Tensor:
    """Static-frame XYZ euler angles ('sxyz') -> rotation matrix
    R = Rz(ak) @ Ry(aj) @ Rx(ai)."""
    ci, si = torch.cos(ai), torch.sin(ai)
    cj, sj = torch.cos(aj), torch.sin(aj)
    ck, sk = torch.cos(ak), torch.sin(ak)
    one, zero = torch.ones_like(ci), torch.zeros_like(ci)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat([[one, zero, zero], [zero, ci, -si], [zero, si, ci]])
    ry = mat([[cj, zero, sj], [zero, one, zero], [-sj, zero, cj]])
    rz = mat([[ck, -sk, zero], [sk, ck, zero], [zero, zero, one]])
    return rz @ (ry @ rx)


def mat_to_euler(m: torch.Tensor):
    """Rotation matrix -> static-frame XYZ euler angles (ai, aj, ak)."""
    sj = -m[..., 2, 0]
    cj = torch.sqrt(torch.clamp(m[..., 0, 0] ** 2 + m[..., 1, 0] ** 2,
                                min=1e-24))
    aj = torch.atan2(sj, cj)
    near_gimbal = cj < 1e-7
    ai = torch.where(near_gimbal, torch.atan2(-m[..., 1, 2], m[..., 1, 1]),
                     torch.atan2(m[..., 2, 1], m[..., 2, 2]))
    ak = torch.where(near_gimbal, torch.zeros_like(aj),
                     torch.atan2(m[..., 1, 0], m[..., 0, 0]))
    return ai, aj, ak


def make_tf(rot: Optional[torch.Tensor] = None,
            trans: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Homogeneous 4x4 transform(s) from a rotation and/or translation."""
    ref = rot if rot is not None else trans
    if ref is None:
        return torch.eye(4)
    batch = ref.shape[:-2] if rot is not None else ref.shape[:-1]
    tf = torch.eye(4, dtype=ref.dtype, device=ref.device).expand(
        batch + (4, 4)).clone()
    if rot is not None:
        tf[..., :3, :3] = rot
    if trans is not None:
        tf[..., :3, 3] = trans
    return tf


def tf_inverse(tf: torch.Tensor) -> torch.Tensor:
    """Invert rigid transform(s) (..., 4, 4)."""
    rt = tf[..., :3, :3].transpose(-1, -2)
    return make_tf(rt, -torch.einsum("...ij,...j->...i", rt, tf[..., :3, 3]))


def apply_tf(tf: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply transform(s) (..., 4, 4) to points (..., N, 3)."""
    return (torch.einsum("...ij,...nj->...ni", tf[..., :3, :3], points)
            + tf[..., None, :3, 3])


def pose_to_tf(quat: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(w,x,y,z) quaternion + translation -> 4x4 transform."""
    return make_tf(quat_to_mat(quat), trans)


def compose_quat_poses(q1, t1, q2, t2):
    """pose1 @ pose2 for (quat, trans) poses (the refiner's composition)."""
    r1 = quat_to_mat(q1)
    t = torch.einsum("...ij,...j->...i", r1, t2) + t1
    return quat_normalize(quat_multiply(q1, q2)), t
