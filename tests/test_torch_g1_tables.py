"""Port parity on the Unitree G1 model's host tables.

The G1 slice is not ported yet (its plane-mesh contacts wait), but the
MJCF compiler, the pair tables with mesh sub-capsule proxies and the
proxy-gap calibration are, and must build the JAX package's tables.
"""
import numpy as np
import pytest

from deepmimic_mujoco_tpu.models import assets as jassets
from deepmimic_mujoco_tpu.models import load_model as jload_model
from deepmimic_mujoco_tpu.physics import collision as jcol

from deepmimic_mujoco_tpu_torch.models import load_model
from deepmimic_mujoco_tpu_torch.physics import collision as tcol


@pytest.fixture(scope="module")
def models():
    path = jassets.xml_path("unitree_g1")
    return jload_model(path), load_model(path)


def test_g1_model_fields_equal(models):
    jm, tm = models
    for f in jm.__dataclass_fields__:
        if f.startswith("_") or f in ("opt", "meshes"):
            continue
        a, b = getattr(jm, f), getattr(tm, f)
        if isinstance(a, tuple) and a and isinstance(a[0], tuple):
            assert a == b, f
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f)
    assert len(jm.meshes) == len(tm.meshes)
    for a, b in zip(jm.meshes, tm.meshes):
        np.testing.assert_array_equal(a.verts, b.verts)
        assert len(a.sub_capsules) == len(b.sub_capsules)


def test_g1_pair_tables_and_proxy_gaps_equal(models):
    jm, tm = models
    jt = jcol.build_pair_tables(jm, 2)
    tt = tcol.build_pair_tables(tm, 2)
    assert jcol.total_slots(jt) == tcol.total_slots(tt) == 1252
    jt = jcol.calibrate_proxy_gaps(jm, jt, jm.key_qpos[0])
    tt = tcol.calibrate_proxy_gaps(tm, tt, tm.key_qpos[0])
    n_gaps = 0
    for jg, tg in zip(jt, tt):
        for f in jg._fields:
            a, b = getattr(jg, f), getattr(tg, f)
            if f == "gap":
                # calibration runs the narrow phase in float32
                np.testing.assert_allclose(b, a, atol=1e-6, err_msg=f)
                n_gaps += int((b < 0).sum())
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              f)
    assert n_gaps > 0, "no proxy rest overlap was calibrated"
