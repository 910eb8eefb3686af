"""Weights carried across from the JAX package.

``params_from_flax`` maps a flax ``ActorCritic`` parameter tree (as
numpy, e.g. from the JAX package's ``rl/checkpoint.py:restore_params``)
onto the port's ``ActorCritic.state_dict()``. Flax ``Dense_i`` kernels
are stored (in, out); the actor is the first ``len(net_arch)+1`` Dense
layers, then the critic's, then ``log_std``.

``actor_from_npz`` reads the ``w0..bN`` actor format of the
``runs/*_extracted.npz`` files (kernels stored (in, out)), with an
optional ``log_std``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.rl.networks import ActorCritic


def params_from_flax(params, net_arch: Sequence[int] = (256, 128)) -> dict:
    p = params.get("params", params)
    nl = len(net_arch) + 1
    sd = {}
    for i in range(2 * nl):
        dense = p[f"Dense_{i}"]
        head = "actor" if i < nl else "critic"
        sd[f"{head}.{i % nl}.weight"] = torch.tensor(
            np.asarray(dense["kernel"], np.float32).T.copy())
        sd[f"{head}.{i % nl}.bias"] = torch.tensor(
            np.asarray(dense["bias"], np.float32))
    sd["log_std"] = torch.tensor(np.asarray(p["log_std"], np.float32))
    return sd


def actor_npz_arrays(net: ActorCritic) -> dict:
    """The actor of ``net`` in the ``w0..bN`` (+ ``log_std``) format."""
    out = {}
    for i, layer in enumerate(net.actor):
        out[f"w{i}"] = layer.weight.detach().cpu().numpy().T.copy()
        out[f"b{i}"] = layer.bias.detach().cpu().numpy().copy()
    out["log_std"] = net.log_std.detach().cpu().numpy().copy()
    return out


def actor_from_npz(path: str, device="cuda",
                   generator: Optional[torch.Generator] = None
                   ) -> ActorCritic:
    """An ``ActorCritic`` whose actor (and log_std, when stored) come
    from ``path``; the critic, absent from the file, keeps its
    orthogonal init drawn from ``generator``."""
    data = np.load(path)
    ws = []
    while f"w{len(ws)}" in data:
        i = len(ws)
        ws.append((np.asarray(data[f"w{i}"], np.float32),
                   np.asarray(data[f"b{i}"], np.float32)))
    net = ActorCritic(ws[0][0].shape[0], ws[-1][0].shape[1],
                      net_arch=tuple(w.shape[1] for w, _ in ws[:-1]),
                      device=device, generator=generator)
    with torch.no_grad():
        for layer, (w, b) in zip(net.actor, ws):
            layer.weight.copy_(torch.as_tensor(w.T.copy()))
            layer.bias.copy_(torch.as_tensor(b))
        if "log_std" in data:
            net.log_std.copy_(torch.as_tensor(
                np.asarray(data["log_std"], np.float32)))
    return net
