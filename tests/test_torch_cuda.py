"""Card-only tests of the PyTorch/CUDA port, plus the device rules that
hold without a card.

This file imports no JAX, so it also runs on a machine that has a CUDA
device and no JAX: ``python -m pytest tests/test_torch_cuda.py -m gpu``.
Tests marked ``gpu`` decide in a fixture whether a card is present and
skip without one.
"""
import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu_torch.envs import DPEnv
from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
from deepmimic_mujoco_tpu_torch.utils.device import resolve_device

TOL_KERNEL = 2e-4   # max|d|/scale, tests/test_fused_solve.py
TOL_STEP = 5e-3
H3D, G1 = (34, 16, 28), (43, 24, 37)


def _mk(seed, B, nv, K, L):
    """Random SPD systems (tests/test_fused_solve.py:_mk, batched) with a
    nonzero warm start, J^T laid out (B, nv, n) for the kernel."""
    n = 3 * K + L
    r = np.random.RandomState(seed)
    G = r.randn(B, nv, nv)
    M = G @ G.transpose(0, 2, 1) + nv * np.eye(nv)
    JT = (r.randn(B, n, nv) * (r.rand(B, n, 1) < 0.8)).transpose(0, 2, 1)
    qf = r.randn(B, nv) * 10
    aref = r.randn(B, n)
    imp = np.clip(r.rand(B, n), 0.05, 0.95)
    act_c = r.rand(B, K) < 0.5
    active = np.concatenate([act_c, act_c, act_c, r.rand(B, L) < 0.3], 1)
    mu = np.full((B, K), 1.0)
    lam0 = r.randn(B, n)
    return [np.ascontiguousarray(x, np.float32)
            for x in (M, JT, qf, aref, imp, active, mu, lam0)]


def _err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(a.abs().max()), 1.0))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dims,B,pyramidal", [(H3D, 2048, False),
                                              (H3D, 1000, True),
                                              (G1, 1000, True)])
def test_kernel_matches_plain_on_card(cuda_device, dims, B, pyramidal):
    nv, K, L = dims
    args = [torch.tensor(a, device=cuda_device)
            for a in _mk(3, B, nv, K, L)]
    before = fs.fused_solve.launches
    got = fs.fused_solve(*args, K=K, L=L, iterations=50, pyramidal=pyramidal)
    torch.cuda.synchronize()
    assert fs.fused_solve.launches == before + 1
    want = fs.fused_solve_plain(*args, K=K, L=L, iterations=50,
                                pyramidal=pyramidal)
    errs = [_err(a, b) for a, b in zip(want, got)]
    assert max(errs) < TOL_KERNEL, errs


@pytest.mark.gpu
def test_env_step_on_card_matches_cpu(cuda_device):
    """One DPEnv step on the card launches the kernel once and agrees
    with the CPU path on the same states and actions."""
    frames = torch.tensor([0, 15, 30, 45, 60, 70])
    act = torch.tensor(np.random.RandomState(0).uniform(
        -1, 1, (len(frames), 28)).astype(np.float32)) * 40
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        env = DPEnv(motion="walk", robot="humanoid3d", device=dev)
        state, _ = env.reset(len(frames), idx_init=frames.to(dev))
        before = fs.fused_solve.launches
        state, out = env.step(state, act.to(dev))
        outs.append((state, out, fs.fused_solve.launches - before))
    (sg, og, ng), (sc, oc, nc) = outs
    assert (ng, nc) == (1, 0)
    for a, b in ((sc.qpos, sg.qpos), (sc.qvel, sg.qvel), (oc.obs, og.obs),
                 (oc.reward, og.reward)):
        assert _err(a, b) < TOL_STEP
    assert torch.equal(oc.done, og.done.cpu())


def test_wrapper_refuses_other_devices():
    args = [torch.empty(a.shape, device="meta") for a in _mk(0, 2, *H3D)]
    with pytest.raises(ValueError, match="unsupported device"):
        fs.fused_solve(*args, K=16, L=28, iterations=5)


def test_cuda_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        DPEnv(motion="walk", robot="humanoid3d")
    assert resolve_device("cpu") == torch.device("cpu")
