from deepmimic_mujoco_tpu_torch.mocap.loader import (  # noqa: F401
    MocapClip, SIM_DT, load_clip,
)
