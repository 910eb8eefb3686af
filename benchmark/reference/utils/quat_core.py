"""Quaternion / rotation math, array-namespace generic.

One implementation serves both the device path (torch, float32, through
the numpy-style namespace in ``utils/quat.py``) and the host
preprocessing path (numpy, float64): ``make_quat_module(xp)`` returns a
namespace of pure, branchless, batch-friendly functions. Constants are
built from the input arrays (never from Python lists) so that torch
tensors on any device work unchanged.

Conventions
-----------
- Quaternions are stored **wxyz** (MuJoCo order) unless a function name
  says otherwise. All functions accept leading batch dimensions.
- ``to_rpy`` is the aerospace roll/pitch/yaw (intrinsic Z-Y'-X'', i.e.
  R = Rz(yaw) @ Ry(pitch) @ Rx(roll)), matching the behavior the
  reference obtains from py3dtf ``Quaternion.to_rpy``
  (reference: src/deepmimic_env.py:56, :163, :217).
- ``euler_*_intrinsic`` implement rotating-frame ("rxyz"/"ryxz") euler
  conventions matching the subset of the Gohlke transformations library
  the reference uses (reference: src/mujoco/mocap_v2.py:142,
  src/retarget.py:79-80).
"""
import types


def make_quat_module(xp):
    """Build the quaternion namespace over array library ``xp``."""

    def normalize(q, eps=1e-12):
        n = xp.sqrt(xp.sum(q * q, axis=-1, keepdims=True))
        return q / xp.maximum(n, eps)

    def mul(a, b):
        """Hamilton product a*b, wxyz."""
        aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return xp.stack(
            [
                aw * bw - ax * bx - ay * by - az * bz,
                aw * bx + ax * bw + ay * bz - az * by,
                aw * by - ax * bz + ay * bw + az * bx,
                aw * bz + ax * by - ay * bx + az * bw,
            ],
            axis=-1,
        )

    def conj(q):
        return xp.concatenate([q[..., :1], -q[..., 1:]], axis=-1)

    def rotate(q, v):
        """Rotate vector(s) v by quaternion(s) q."""
        qv = q[..., 1:]
        w = q[..., :1]
        t = 2.0 * xp.cross(qv, v)
        return v + w * t + xp.cross(qv, t)

    def rotate_inv(q, v):
        return rotate(conj(q), v)

    def to_mat(q):
        """3x3 rotation matrix from wxyz quaternion (assumes unit-ish)."""
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        n = w * w + x * x + y * y + z * z
        s = 2.0 / xp.maximum(n, 1e-12)
        wx, wy, wz = s * w * x, s * w * y, s * w * z
        xx, xy, xz = s * x * x, s * x * y, s * x * z
        yy, yz, zz = s * y * y, s * y * z, s * z * z
        m = xp.stack(
            [
                1.0 - (yy + zz), xy - wz, xz + wy,
                xy + wz, 1.0 - (xx + zz), yz - wx,
                xz - wy, yz + wx, 1.0 - (xx + yy),
            ],
            axis=-1,
        )
        return m.reshape(m.shape[:-1] + (3, 3))

    def from_mat(m):
        """wxyz quaternion from 3x3 rotation matrix, branchless.

        Computes all four Shepperd candidates and selects the best-
        conditioned one, so it is safe on batched tensors.
        """
        m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
        m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
        m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
        tr = m00 + m11 + m22
        # Four candidate 4*q*q_i vectors (unnormalized), one per pivot.
        qw = xp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
        qx = xp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
        qy = xp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
        qz = xp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)
        pivots = xp.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                           1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1)
        idx = xp.argmax(pivots, axis=-1)
        cands = xp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4 cand, 4)
        q = xp.take_along_axis(cands, idx[..., None, None], axis=-2)[..., 0, :]
        q = normalize(q)
        # canonical sign: w >= 0
        return q * xp.where(q[..., :1] < 0, -1.0, 1.0)

    def from_axis_angle(axis, angle):
        axis = axis / xp.maximum(
            xp.sqrt(xp.sum(axis * axis, axis=-1, keepdims=True)), 1e-12
        )
        half = angle[..., None] * 0.5
        return xp.concatenate([xp.cos(half), axis * xp.sin(half)], axis=-1)

    def to_axis_angle(q):
        """(axis, angle) with angle in [0, pi]-ish; safe near identity."""
        qn = normalize(q)
        sign = xp.where(qn[..., :1] < 0, -1.0, 1.0)
        qn = qn * sign  # w >= 0 -> angle in [0, pi]
        w = xp.clip(qn[..., 0], -1.0, 1.0)
        s = xp.sqrt(xp.maximum(1.0 - w * w, 1e-24))
        angle = 2.0 * xp.arctan2(s, w)
        axis = qn[..., 1:] / s[..., None]
        # near identity, direction is arbitrary; use x-axis, angle ~ 0
        tiny = (s < 1e-9)[..., None]
        default = xp.concatenate(
            [xp.ones_like(axis[..., :1]), xp.zeros_like(axis[..., 1:])],
            axis=-1)
        axis = xp.where(tiny, default, axis)
        return axis, angle

    def log3(q):
        """Rotation vector (axis*angle) of quaternion."""
        axis, angle = to_axis_angle(q)
        return axis * angle[..., None]

    def vel_from_quats(q0, q1, dt):
        """Angular velocity taking q0 to q1 over dt, local(q0) frame.

        Matches the reference's finite-difference root angular velocity
        axis*angle of (q0^-1 * q1) / dt (reference:
        src/mujoco/mocap_v2.py:350-362).
        """
        return log3(mul(conj(q0), q1)) / dt

    def integrate(q, omega_local, dt):
        """q_next = q * exp(dt/2 * omega), omega in local (body) frame.

        Matches MuJoCo free/ball joint velocity convention (angular
        velocity stored in the child body frame).
        """
        w = omega_local
        angle = xp.sqrt(xp.sum(w * w, axis=-1)) * dt
        axis = w / xp.maximum(
            xp.sqrt(xp.sum(w * w, axis=-1, keepdims=True)), 1e-12
        )
        dq = from_axis_angle(axis, angle)
        return normalize(mul(q, dq))

    def to_rpy(q):
        """Roll/pitch/yaw (intrinsic ZYX) from wxyz quaternion."""
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        roll = xp.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
        pitch = xp.arcsin(xp.clip(2.0 * (w * y - z * x), -1.0, 1.0))
        yaw = xp.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
        return xp.stack([roll, pitch, yaw], axis=-1)

    # ---- intrinsic euler conversions (rotating frame) ----------------
    _AX = {"x": 0, "y": 1, "z": 2}

    def _axis_quat(axis_name, angle):
        zeros = xp.zeros_like(angle)
        half = angle * 0.5
        c, s = xp.cos(half), xp.sin(half)
        comps = {"x": [c, s, zeros, zeros],
                 "y": [c, zeros, s, zeros],
                 "z": [c, zeros, zeros, s]}[axis_name]
        return xp.stack(comps, axis=-1)

    def euler_to_quat_intrinsic(e, order):
        """wxyz quaternion from intrinsic euler angles.

        ``order`` like "xyz" (== transformations 'rxyz') or "yxz"
        (== 'ryxz'): R = R_order[0](e0) @ R_order[1](e1) @ R_order[2](e2).
        """
        q = _axis_quat(order[0], e[..., 0])
        q = mul(q, _axis_quat(order[1], e[..., 1]))
        q = mul(q, _axis_quat(order[2], e[..., 2]))
        return q

    def quat_to_euler_intrinsic(q, order):
        """Intrinsic euler angles (order as above) from wxyz quaternion.

        Branchless Tait-Bryan extraction from the rotation matrix; valid
        for orders with three distinct axes.
        """
        m = to_mat(q)
        i, j, k = _AX[order[0]], _AX[order[1]], _AX[order[2]]
        # parity: +1 if (i,j,k) is an even permutation of (0,1,2)
        even = (j - i) % 3 == 1
        sgn = 1.0 if even else -1.0
        # R = Ri(a) Rj(b) Rk(c):  m[i,k] = sgn * sin(b)
        sy = xp.clip(sgn * m[..., i, k], -1.0, 1.0)
        b = xp.arcsin(sy)
        a = xp.arctan2(-sgn * m[..., j, k], m[..., k, k])
        c = xp.arctan2(-sgn * m[..., i, j], m[..., i, i])
        return xp.stack([a, b, c], axis=-1)

    ns = types.SimpleNamespace(
        normalize=normalize, mul=mul, conj=conj, rotate=rotate,
        rotate_inv=rotate_inv, to_mat=to_mat, from_mat=from_mat,
        from_axis_angle=from_axis_angle, to_axis_angle=to_axis_angle,
        log3=log3, vel_from_quats=vel_from_quats, integrate=integrate,
        to_rpy=to_rpy, euler_to_quat_intrinsic=euler_to_quat_intrinsic,
        quat_to_euler_intrinsic=quat_to_euler_intrinsic,
    )
    return ns
