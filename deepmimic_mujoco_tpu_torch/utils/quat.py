"""Device quaternion math over torch (batched, any device).

``quat_core.make_quat_module`` is written against a numpy-style
namespace; ``_TorchNP`` maps the names it uses onto torch.
"""
import types

import torch

from deepmimic_mujoco_tpu_torch.utils.quat_core import make_quat_module


def _maximum(a, b):
    if isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    return torch.clamp(a, min=b)


_TorchNP = types.SimpleNamespace(
    sqrt=torch.sqrt, sum=torch.sum, maximum=_maximum, stack=torch.stack,
    concatenate=torch.cat, cross=lambda a, b: torch.linalg.cross(a, b, dim=-1),
    argmax=torch.argmax,
    take_along_axis=lambda a, i, axis: torch.take_along_dim(a, i, dim=axis),
    cos=torch.cos, sin=torch.sin, where=torch.where,
    zeros_like=torch.zeros_like, ones_like=torch.ones_like,
    clip=torch.clip, arctan2=torch.atan2, arcsin=torch.asin,
)

_q = make_quat_module(_TorchNP)

normalize = _q.normalize
mul = _q.mul
conj = _q.conj
rotate = _q.rotate
rotate_inv = _q.rotate_inv
to_mat = _q.to_mat
from_mat = _q.from_mat
from_axis_angle = _q.from_axis_angle
to_axis_angle = _q.to_axis_angle
log3 = _q.log3
vel_from_quats = _q.vel_from_quats
integrate = _q.integrate
to_rpy = _q.to_rpy
euler_to_quat_intrinsic = _q.euler_to_quat_intrinsic
quat_to_euler_intrinsic = _q.quat_to_euler_intrinsic
