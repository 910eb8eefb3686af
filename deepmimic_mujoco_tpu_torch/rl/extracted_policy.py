"""Deployment artifact: a dependency-free NumPy MLP policy.

The port's copy of the JAX package's ``rl/extracted_policy.py`` (the
reference ships a hand-inlined 66->256->128->28 tanh MLP with a
golden-vector self-test: src/extracted_policy.py:6-485). Extraction is
a function of any trained ``ActorCritic`` or ``PDTargetActorCritic``:
the actor's weights go to an .npz (``w0..bN``, float64, kernels stored
(in, out); a PD net adds its ``pd_*`` transform) plus a JSON golden
vector, the same files the JAX package writes, and ``ExtractedPolicy``
runs inference with numpy only.
"""
from __future__ import annotations

import json
import os

import numpy as np


class ExtractedPolicy:
    """Numpy-only deterministic actor: obs -> mean action."""

    def __init__(self, weights_path: str):
        data = np.load(weights_path)
        self.layers = []
        i = 0
        while f"w{i}" in data:
            self.layers.append((data[f"w{i}"], data[f"b{i}"]))
            i += 1
        self.pd = None
        if "pd_kp" in data:
            self.pd = (data["pd_kp"], data["pd_kd"],
                       data["pd_qvel_cols"].astype(int),
                       float(data["pd_vel_obs_scale"]),
                       float(data["pd_act_scale"]))
        golden_path = weights_path.replace(".npz", "_golden.json")
        self.golden = None
        if os.path.exists(golden_path):
            with open(golden_path) as f:
                self.golden = json.load(f)

    def act(self, obs):
        obs = np.asarray(obs, np.float64)
        x = obs
        for i, (w, b) in enumerate(self.layers):
            x = x @ w + b
            if i < len(self.layers) - 1:
                x = np.tanh(x)
        if self.pd is not None:
            # PD-delta policies (networks.PDTargetActorCritic): the
            # network output is a joint delta; the env action is
            # (kp*delta - kd*qvel)/act_scale with qvel read from obs
            kp, kd, cols, vscale, ascale = self.pd
            x = (kp * x - kd * obs[..., cols] / vscale) / ascale
        return x

    def test(self):
        """Golden-vector self-test (reference: src/extracted_policy.py:
        480-485): raises when the weights do not give the recorded
        action."""
        if self.golden is None:
            raise ValueError("no golden vector saved")
        obs = np.asarray(self.golden["obs"])
        want = np.asarray(self.golden["action"])
        got = self.act(obs)
        if not np.allclose(got, want, atol=1e-5):
            raise ValueError(f"golden-vector test failed: {got} != {want}")
        return True


def extract_policy(net, obs_example, out_path: str) -> str:
    """Export the actor of ``net`` (the port's ``ActorCritic``, or a
    ``PDTargetActorCritic`` whose PD transform is baked into the
    artifact) to .npz + golden vector JSON. Returns the .npz path."""
    import torch

    from deepmimic_mujoco_tpu_torch.rl.networks import env_action

    arr = lambda t: t.detach().cpu().numpy().astype(np.float64)
    arrs = {}
    for i, layer in enumerate(net.actor):
        arrs[f"w{i}"] = arr(layer.weight).T.copy()
        arrs[f"b{i}"] = arr(layer.bias)
    if hasattr(net, "env_action"):
        arrs["pd_kp"], arrs["pd_kd"] = net.pd_gains
        arrs["pd_qvel_cols"] = net.qvel_cols.cpu().numpy().astype(np.int64)
        arrs["pd_vel_obs_scale"] = np.float64(net.vel_obs_scale)
        arrs["pd_act_scale"] = np.float64(net.act_scale)
    out_path = os.path.expanduser(out_path)
    if not out_path.endswith(".npz"):
        out_path += ".npz"
    np.savez(out_path, **arrs)

    # golden vector via the numpy path, held to the torch forward
    pol = ExtractedPolicy(out_path)
    obs = np.asarray(obs_example, np.float64)
    action = pol.act(obs)
    dev = next(net.parameters()).device
    with torch.no_grad():
        o32 = torch.as_tensor(obs, dtype=torch.float32, device=dev)
        mean = env_action(net, o32, net(o32)[0]).cpu().numpy()
    if not np.allclose(mean, action, atol=1e-4):
        raise ValueError("extracted policy disagrees with the torch forward")
    with open(out_path.replace(".npz", "_golden.json"), "w") as f:
        json.dump({"obs": obs.tolist(), "action": action.tolist(),
                   "source_checkpoint": out_path}, f)
    return out_path
