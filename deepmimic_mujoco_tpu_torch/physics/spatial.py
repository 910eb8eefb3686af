"""Spatial (6D) vector algebra in the world-aligned com frame.

Vectors are ordered [angular(3); linear(3)] (engine convention for
cvel/cdof/cacc). All functions broadcast over leading batch dimensions.
"""
import torch


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def motion_cross(v, m):
    """Motion x motion: time derivative of a motion vector m seen from
    a frame moving with spatial velocity v."""
    vw, vv = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    return torch.cat([_cross(vw, mw), _cross(vw, mv) + _cross(vv, mw)], -1)


def force_cross(v, f):
    """Motion x* force: bias force of momentum f under velocity v."""
    vw, vv = v[..., :3], v[..., 3:]
    fw, fv = f[..., :3], f[..., 3:]
    return torch.cat([_cross(vw, fw) + _cross(vv, fv), _cross(vw, fv)], -1)


def inertia_matrix(mass, inertia_com, r):
    """6x6 spatial inertia about a point o, [w; v] ordering.

    mass: (...,), inertia_com: (..., 3, 3) world-aligned rotational
    inertia about the body com, r: (..., 3) = com - o.
    Maps [w; v_o] -> [L_o; p].
    """
    rx = skew(r)
    m = mass[..., None, None]
    top_left = inertia_com - m * (rx @ rx)
    eye = torch.eye(3, dtype=inertia_com.dtype, device=inertia_com.device)
    top = torch.cat([top_left, m * rx], -1)
    bottom = torch.cat([-m * rx, m * eye.expand(rx.shape)], -1)
    return torch.cat([top, bottom], -2)


def skew(r):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1)
    return m.reshape(m.shape[:-1] + (3, 3))
