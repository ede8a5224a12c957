"""Quaternion / rotation / spatial-vector algebra.

Conventions as in ``ilqg_mujoco_tpu/physics/spatial.py``:

* quaternions are MuJoCo order ``(w, x, y, z)``;
* spatial motion vectors are angular-first ``V = (omega, v_o)`` at the world
  origin, force vectors ``F = (n_o, f)``.

Every function takes tensors with any leading batch dims.  The quaternion
exponential and log maps (``quat_integrate``, ``quat_sub``) carry the JAX
package's dtype-aware regularisers, so that forward-mode derivatives and
cost Hessians through a zero rotation stay finite.
"""

from __future__ import annotations

import torch


def quat_mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ p (both (…,4), MuJoCo wxyz order)."""
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = p.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt((q * q).sum(-1, keepdim=True))


def _eps(dtype) -> float:
    """The regulariser inside the square roots of the exponential and log
    maps: second derivatives carry 1/theta^3 terms, so theta_min^3 must stay
    inside the dtype's range (1e-15 in float64, 1e-6 in float32)."""
    return 1e-30 if dtype == torch.float64 else 1e-12


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """MuJoCo mju_quatIntegrate: q rotated by the local-frame angular
    velocity omega for dt, q ⊗ exp(omega dt / 2), as a smooth exponential
    (regularised theta, no normalise-the-axis branch), so that forward-mode
    AD through it is finite at omega = 0."""
    v = omega * dt
    theta = torch.sqrt((v * v).sum(-1) + _eps(v.dtype))
    half = 0.5 * theta
    s = torch.sin(half) / theta         # -> 0.5 smoothly as theta -> 0
    dq = torch.cat([torch.cos(half)[..., None], s[..., None] * v], -1)
    return quat_normalize(quat_mul(q, dq))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """MuJoCo mju_subQuat: the 3-vector v with qb ⊗ exp(v / 2) = qa, on the
    shortest arc."""
    dq = quat_mul(quat_conj(qb), qa)
    sin_half = torch.sqrt((dq[..., 1:] ** 2).sum(-1) + _eps(dq.dtype))
    cos_half = dq[..., 0]
    angle = 2.0 * torch.atan2(sin_half, cos_half)
    angle = torch.where(angle > torch.pi, angle - 2 * torch.pi, angle)
    # v = vec(dq) * angle / sin_half.  At a zero rotation the ratio takes
    # its limit 2 / cos_half, so the map's derivative there is 2 I (the JAX
    # package divides by 1 instead, which zeroes the derivative and with it
    # the rotation rows of linearize_exact's A).  The denominator is
    # guarded, not the quotient: torch.where evaluates both branches, and a
    # NaN in the one not taken would poison a tangent.
    small = sin_half <= 1e-14
    ratio = torch.where(small, 2.0 / torch.where(small, cos_half, 1.0),
                        angle / torch.where(small, 1.0, sin_half))
    return dq[..., 1:] * ratio[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3-vector cross product over the last dim, broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (R(q) @ v)."""
    qw, qv = q[..., :1], q[..., 1:]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 3x3 rotation matrix (…,3,3)."""
    w, x, y, z = q.unbind(-1)
    r0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        dim=-1)
    r1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        dim=-1)
    r2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis + angle -> quaternion. axis (…,3), angle (…,)."""
    half = 0.5 * angle
    s = torch.sin(half)
    cos = torch.cos(half)[..., None]
    return torch.cat([cos, (axis * s[..., None]).expand(cos.shape[:-1] + (3,))],
                     dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [v]x, (…,3) -> (…,3,3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def cross_motion(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v ×m m (both (…,6))."""
    w, vo = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, mv) + cross(vo, mw)], dim=-1)


def cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v ×f f (dual of cross_motion)."""
    w, vo = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(vo, fl), cross(w, fl)], dim=-1)


def spatial_inertia(mass, inertia_diag, com, rot) -> torch.Tensor:
    """6x6 spatial inertia in world Plücker coordinates at the origin.

    mass (…,), inertia_diag (…,3) principal body inertia, com (…,3) world
    position of the center of mass, rot (…,3,3) world-from-inertial rotation:
      I = [[ I_c + m*Sc*Sc^T ,  m*Sc ],
           [ m*Sc^T          ,  m*1  ]],  Sc = skew(com),
    I_c = R diag(inertia) R^T."""
    m = mass[..., None, None]
    Ic = (rot * inertia_diag[..., None, :]) @ rot.transpose(-1, -2)
    Sc = skew(com)
    mSc = m * Sc
    eye = torch.eye(3, dtype=com.dtype, device=com.device)
    top = torch.cat([Ic + mSc @ Sc.transpose(-1, -2), mSc], -1)
    bottom = torch.cat([mSc.transpose(-1, -2), (m * eye).expand_as(Sc)], -1)
    return torch.cat([top, bottom], -2)
