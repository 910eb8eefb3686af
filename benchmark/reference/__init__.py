"""The plain reference that decides a run's ``correct``.

Plain PyTorch, in float64 (the control: float32 with TF32 matmuls). It
imports nothing of the port and nothing of JAX. It reads the MJCF and
mocap files vendored under ``deepmimic_mujoco_tpu/assets`` by path.

- ``physics/``, ``models/``, ``mocap/``, ``envs/``, ``utils/``: a frozen
  copy of the port's plain CPU path (taken at the commit that added this
  benchmark), its imports pointed inside this folder, its float type set
  by ``utils.device.DT`` (float64 by default), the mocap FK in float64,
  and the fused-solve kernel replaced by its plain version (``solve.py``).
  It rebuilds every model table from the MJCF and every clip table from
  the mocap files.
- ``policy.py``: the actor-critic's init from the seed, forward and
  sample; ``ppo.py``: GAE and the clipped update with Adam.
- ``check.py``: the comparisons, and ``limits/<cell>.json`` their limits.
"""
