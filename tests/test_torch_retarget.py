"""Port parity: the humanoid3d -> G1 retargeting tool against the JAX
package's.

- ``_continuity_pick`` equal to the JAX one (the same float64 numpy
  arithmetic) on random eulers, limits and targets, clipped or not.
- The walk clip retargeted by each package into a writable asset root of
  its own (symlinks to the real root, the target clip left out): the
  two files are byte-identical, and a second call raises
  ``FileExistsError`` where ``overwrite`` is not set.
- ``validate_clip`` of that clip on the CPU: the rewards within 1e-5 of
  the JAX package's, with mean > 0.9 (tests/test_retarget_e2e.py's
  bar).

Nothing is written under ``deepmimic_mujoco_tpu/``; the JAX package's
id-keyed table caches forget this module's models when it ends.
"""
import os

import numpy as np
import pytest

from deepmimic_mujoco_tpu.models import assets as jassets
from deepmimic_mujoco_tpu.tools import retarget as jretarget

from deepmimic_mujoco_tpu_torch.models import assets
from deepmimic_mujoco_tpu_torch.tools import retarget

TARGET = "unitree_g1_walk.txt"
TOL_REWARD = 1e-5


@pytest.fixture(scope="module", autouse=True)
def forget_jax_model_tables():
    """The JAX package caches per-model tables under ``id(model)``
    (``physics/kinematics.py:_TREE_CACHE``, ``tools/render.py:
    _SCENE_CACHE``). Once this module's models are gone, a model made
    later in the same process can get one of their ids and be served
    their tables (a humanoid3d model the G1's). So the entries this
    module added are dropped when it ends."""
    from deepmimic_mujoco_tpu.physics import kinematics as jkin
    from deepmimic_mujoco_tpu.tools import render as jrender_mod

    caches = (jkin._TREE_CACHE, jrender_mod._SCENE_CACHE)
    before = [set(c) for c in caches]
    yield
    for cache, keys in zip(caches, before):
        for key in set(cache) - keys:
            del cache[key]


def _writable_root(root, real):
    """An asset root whose motions/ is writable: every clip linked but
    the retarget target, everything else linked to the real root."""
    root.mkdir()
    os.symlink(os.path.join(real, "humanoid_deepmimic"),
               root / "humanoid_deepmimic")
    motions = root / "motions"
    motions.mkdir()
    for f in os.listdir(os.path.join(real, "motions")):
        if f != TARGET:
            os.symlink(os.path.join(real, "motions", f), motions / f)
    return root


@pytest.fixture(scope="module")
def retargeted(tmp_path_factory):
    """The walk clip written by each package into its own writable root:
    {"jax": path, "port": path}."""
    real = assets.asset_root()
    base = tmp_path_factory.mktemp("retarget")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for side in ("jax", "port"):
            root = str(_writable_root(base / side, real))
            mp.setenv("DM_TPU_ASSET_ROOT", root)
            mp.setattr(jassets, "_DEFAULT_ROOTS", (root,))
            tool = jretarget if side == "jax" else retarget
            out[side] = tool.retarget_motion_humanoid_to_unitree_g1(
                "walk", validate=False)
            assert out[side] == os.path.join(root, "motions", TARGET)
            with pytest.raises(FileExistsError):
                tool.retarget_motion_humanoid_to_unitree_g1(
                    "walk", validate=False)
    finally:
        mp.undo()
    return out


def test_continuity_pick_matches_jax():
    r = np.random.RandomState(0)
    clipped = 0
    for _ in range(40):
        lims = [np.sort(r.uniform(-3, 3, 2)) for _ in range(3)]
        prev = np.array([r.uniform(lo, hi) for lo, hi in lims])
        e_raw = prev + r.normal(0, 0.6, 3)
        q = r.normal(size=4)
        q /= np.linalg.norm(q)
        dt = r.choice([1 / 30, 1 / 60])
        want = jretarget._continuity_pick(e_raw, prev, lims, q,
                                          jretarget.VMX, dt)
        got = retarget._continuity_pick(e_raw, prev, lims, q,
                                        retarget.VMX, dt)
        np.testing.assert_array_equal(got, want)
        clipped += not np.array_equal(got, e_raw)
    assert clipped > 10      # the grid search ran, not only the fast path
    assert retarget.NAIVE_MAP.keys() == jretarget.NAIVE_MAP.keys()


def test_retargeted_walk_is_byte_identical(retargeted):
    with open(retargeted["jax"], "rb") as a, \
            open(retargeted["port"], "rb") as b:
        ja, tb = a.read(), b.read()
    assert len(ja) > 10_000 and ja == tb
    vendored = os.path.realpath(assets.asset_root())
    for path in retargeted.values():
        assert not os.path.realpath(path).startswith(vendored), path


def test_validate_clip_matches_jax(retargeted, monkeypatch):
    root = os.path.dirname(os.path.dirname(retargeted["port"]))
    monkeypatch.setenv("DM_TPU_ASSET_ROOT", root)
    monkeypatch.setattr(jassets, "_DEFAULT_ROOTS", (root,))
    want = jretarget.validate_clip("walk")
    got = retarget.validate_clip("walk", device="cpu")
    assert got.shape == want.shape and len(got) > 20
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_REWARD)
    assert got.mean() > 0.9, got.mean()
