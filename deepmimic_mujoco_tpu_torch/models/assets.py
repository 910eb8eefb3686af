"""Asset path resolution (MJCF robot models + mocap clips).

The port reads the assets vendored with the JAX package in place, by
path: ``<repo>/deepmimic_mujoco_tpu/assets``, resolved from this file's
location without importing that package. ``DM_TPU_ASSET_ROOT``
overrides the vendored root, as in the JAX package.
"""
import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_VENDORED_ROOT = os.path.join(_REPO, "deepmimic_mujoco_tpu", "assets")


def asset_root() -> str:
    for root in (os.environ.get("DM_TPU_ASSET_ROOT", ""), _VENDORED_ROOT):
        if root and os.path.isdir(root):
            return root
    raise FileNotFoundError(
        "No asset root found; set DM_TPU_ASSET_ROOT to a directory with "
        "humanoid_deepmimic/envs/asset/*.xml and motions/*.txt")


def xml_path(robot: str) -> str:
    return os.path.join(asset_root(), "humanoid_deepmimic", "envs", "asset",
                        f"deepmimic_{robot}.xml")


def mocap_path(robot: str, motion: str) -> str:
    return os.path.join(asset_root(), "motions", f"{robot}_{motion}.txt")
