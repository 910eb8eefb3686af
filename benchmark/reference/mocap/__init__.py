from reference.mocap.loader import (  # noqa: F401
    MocapClip, SIM_DT, load_clip,
)
