"""Host quaternion math (numpy, float64) for one-time preprocessing.

Used by the mocap pipeline and retargeting tool, where float64 and
host-side control flow are appropriate. Same conventions as
``reference.utils.quat`` (wxyz).
"""
import numpy as np

from reference.utils.quat_core import make_quat_module

_q = make_quat_module(np)

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
