"""Sensor evaluation: gyro, accelerometer, framequat on sites, batched.

The G1 model carries an IMU sensor suite (reference:
deepmimic_unitree_g1.xml:432-436: gyro + accelerometer + framequat on
the ``imu`` site). Values are computed from the engine's own data (site
frames, body spatial velocities), as the JAX package's
``physics/sensors.py`` computes them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.models.physics_model import PhysicsModel
from deepmimic_mujoco_tpu_torch.physics.step import EngineData
from deepmimic_mujoco_tpu_torch.utils import quat as tq


def evaluate_sensors(m: PhysicsModel, data: EngineData
                     ) -> Dict[str, torch.Tensor]:
    """Evaluate all declared site sensors; returns {f"{type}_{index}":
    (B, 3) or (B, 4)}.

    gyro: site-frame angular velocity. accelerometer: site-frame linear
    acceleration including gravity (classic IMU convention), as the JAX
    package approximates it: the quasi-static term plus the centripetal
    one, without the body's own acceleration (so it is not MuJoCo's
    accelerometer). framequat: world orientation of the site frame.
    """
    out = {}
    xpos = data.kin.xpos
    grav = torch.as_tensor(np.asarray(m.opt.gravity), dtype=xpos.dtype,
                           device=xpos.device)
    for i, (stype, sid) in enumerate(zip(m.sensor_types, m.sensor_siteid)):
        if sid < 0:
            continue
        body = int(m.site_bodyid[sid])
        site_mat = data.kin.site_xmat[:, sid]          # (B, 3, 3)
        site_pos = data.kin.site_xpos[:, sid]
        if stype == "gyro":
            w_world = data.cvel[:, body, :3]
            out[f"{stype}_{i}"] = torch.einsum("bji,bj->bi", site_mat,
                                               w_world)
        elif stype == "accelerometer":
            w = data.cvel[:, body, :3]
            anchor = data.com.subtree_com[:, int(m.body_rootid[body])]
            cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
            centripetal = cross(w, cross(w, site_pos - anchor))
            out[f"{stype}_{i}"] = torch.einsum("bji,bj->bi", site_mat,
                                               centripetal - grav)
        elif stype == "framequat":
            site_quat = torch.as_tensor(np.asarray(m.site_quat[sid]),
                                        dtype=xpos.dtype, device=xpos.device)
            body_quat = data.kin.xquat[:, body]
            out[f"{stype}_{i}"] = tq.mul(body_quat,
                                         site_quat.expand_as(body_quat))
    return out
