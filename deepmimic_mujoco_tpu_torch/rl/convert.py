"""Weights carried across from the JAX package.

``params_from_flax`` maps a flax ``ActorCritic`` (or
``PDTargetActorCritic``) parameter tree (as numpy, e.g. from the JAX
package's ``rl/checkpoint.py:restore_params``) onto the port's
``state_dict()``. Flax ``Dense_i`` kernels are stored (in, out); the
actor is the first ``len(net_arch)+1`` Dense layers, then the critic's,
then ``log_std``.

``actor_from_npz`` reads the ``w0..bN`` actor format of the
``runs/*_extracted.npz`` files (kernels stored (in, out)), with an
optional ``log_std``.

SAC: ``sac_params_from_flax`` maps the JAX package's SAC ``Actor``
(``Dense_0..Dense_{k-1}`` trunk, ``Dense_k`` mean head, ``Dense_{k+1}``
log-std head) and ``DoubleCritic`` (``Critic_0/1``, each ``Dense_0..
Dense_k``) trees onto the port's ``rl/sac.py`` modules. The SAC actor's
npz format is ``w0..w{k-1}``/``b0..b{k-1}`` for the trunk, then
``w_mean``/``b_mean`` and ``w_log_std``/``b_log_std``, kernels stored
(in, out).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.rl.networks import ActorCritic
from deepmimic_mujoco_tpu_torch.rl.sac import Actor


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


def _dense_sd(dense) -> tuple:
    return (torch.tensor(np.asarray(dense["kernel"], np.float32).T.copy()),
            torch.tensor(np.asarray(dense["bias"], np.float32)))


def sac_params_from_flax(actor_params=None, critic_params=None):
    """(actor state dict, critic state dict) of the port's ``Actor`` and
    ``DoubleCritic`` from the JAX package's flax trees (either may be
    None)."""
    actor_sd = critic_sd = None
    if actor_params is not None:
        p = actor_params.get("params", actor_params)
        n = len(p) - 2
        actor_sd = {}
        for i in range(n + 2):
            name = (f"trunk.{i}" if i < n
                    else ("mean", "log_std")[i - n])
            actor_sd[f"{name}.weight"], actor_sd[f"{name}.bias"] = \
                _dense_sd(p[f"Dense_{i}"])
    if critic_params is not None:
        p = critic_params.get("params", critic_params)
        critic_sd = {}
        for c in range(2):
            q = p[f"Critic_{c}"]
            for j in range(len(q)):
                key = f"critics.{c}.layers.{j}"
                critic_sd[f"{key}.weight"], critic_sd[f"{key}.bias"] = \
                    _dense_sd(q[f"Dense_{j}"])
    return actor_sd, critic_sd


def sac_actor_npz_arrays(actor: Actor) -> dict:
    """The SAC actor in its npz format (see the module docstring)."""
    arr = lambda t: t.detach().cpu().numpy()
    out = {}
    for i, layer in enumerate(actor.trunk):
        out[f"w{i}"] = arr(layer.weight).T.copy()
        out[f"b{i}"] = arr(layer.bias).copy()
    for head in ("mean", "log_std"):
        layer = getattr(actor, head)
        out[f"w_{head}"] = arr(layer.weight).T.copy()
        out[f"b_{head}"] = arr(layer.bias).copy()
    return out


def sac_actor_from_npz(path: str, device="cuda") -> Actor:
    """The SAC ``Actor`` stored at ``path`` in its npz format."""
    data = np.load(path)
    ws = []
    while f"w{len(ws)}" in data:
        ws.append(np.asarray(data[f"w{len(ws)}"], np.float32))
    w_mean = np.asarray(data["w_mean"], np.float32)
    actor = Actor(ws[0].shape[0], w_mean.shape[1],
                  net_arch=tuple(w.shape[1] for w in ws), device=device)
    sd = {}
    for i, w in enumerate(ws):
        sd[f"trunk.{i}.weight"] = torch.as_tensor(w.T.copy())
        sd[f"trunk.{i}.bias"] = torch.as_tensor(data[f"b{i}"])
    for head in ("mean", "log_std"):
        sd[f"{head}.weight"] = torch.as_tensor(
            np.asarray(data[f"w_{head}"], np.float32).T.copy())
        sd[f"{head}.bias"] = torch.as_tensor(
            np.asarray(data[f"b_{head}"], np.float32))
    actor.load_state_dict(sd)
    return actor
