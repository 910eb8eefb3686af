"""Policy/value networks matching the reference's SB3 MlpPolicy.

Separate tanh MLP trunks for actor and critic with net_arch [256, 128]
(reference: src/sb3_ppo.py:265), orthogonal init (sqrt(2) hidden, 0.01
policy head, 1.0 value head), diagonal Gaussian with a state-independent
log-std parameter — the layout of the JAX package's flax ``ActorCritic``
(``rl/convert.py`` carries its weights across).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from deepmimic_mujoco_tpu_torch.utils.device import resolve_device


class _ClipPreserveInward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        # strict inequalities: for lo <= x <= hi the gradient is the
        # identity, as for clamp. Strictly outside, the descent direction
        # is -g: below the floor block g > 0 (it would push x further
        # down), above the ceiling block g < 0.
        (x,) = ctx.saved_tensors
        g = torch.where((x < ctx.lo) & (g > 0), 0.0, g)
        g = torch.where((x > ctx.hi) & (g < 0), 0.0, g)
        return g, None, None


def clip_preserve_inward(x, lo, hi):
    """``clamp(x, lo, hi)`` with inward-preserving gradients (the JAX
    package's custom VJP): the gradient is the identity except where it
    would push ``x`` further outside the bounds, so a log-std parameter
    that crossed its floor can still be pulled back inside by gradient
    descent (a hard clamp's gradient is zero there)."""
    return _ClipPreserveInward.apply(x, lo, hi)


class ActorCritic(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int,
                 net_arch: Sequence[int] = (256, 128),
                 init_log_std: float = 0.0, log_std_min: float = -4.0,
                 log_std_max: float = 1.0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.log_std_min = log_std_min
        self.log_std_max = log_std_max

        def mlp(out_dim, head_gain):
            dims = [obs_dim, *net_arch]
            layers = [nn.Linear(a, b, device=dev)
                      for a, b in zip(dims[:-1], dims[1:])]
            layers.append(nn.Linear(dims[-1], out_dim, device=dev))
            gains = [math.sqrt(2)] * len(net_arch) + [head_gain]
            with torch.no_grad():
                for layer, g in zip(layers, gains):
                    nn.init.orthogonal_(layer.weight, gain=g,
                                        generator=generator)
                    layer.bias.zero_()
            return nn.ModuleList(layers)

        self.actor = mlp(action_dim, 0.01)
        self.critic = mlp(1, 1.0)
        self.log_std = nn.Parameter(torch.full(
            (action_dim,), float(init_log_std), device=dev))

    @staticmethod
    def _trunk(layers, x):
        for layer in layers[:-1]:
            x = torch.tanh(layer(x))
        return layers[-1](x)

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs (..., obs_dim) -> (mean, log_std, value)."""
        mean = self._trunk(self.actor, obs)
        value = self._trunk(self.critic, obs)[..., 0]
        log_std = clip_preserve_inward(self.log_std, self.log_std_min,
                                       self.log_std_max)
        return mean, log_std, value


def sample_action(mean, log_std, generator: Optional[torch.Generator] = None):
    std = torch.exp(log_std)
    noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                        device=mean.device)
    action = mean + std * noise
    return action, gaussian_logp(action, mean, log_std)


def gaussian_logp(action, mean, log_std):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return (-0.5 * z ** 2 - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)


def gaussian_entropy(log_std):
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)


class PDTargetActorCritic(ActorCritic):
    """ActorCritic whose action is a PD-style joint-space delta:

        torque_i = kp_i * a_i - kd_i * qvel_i
        env_action = torque / act_scale

    Joint velocities are read from the observation itself (the columns
    ``qvel_cols`` hold each actuated joint's ``qvel * vel_obs_scale``),
    so the deployed policy stays a pure obs -> env-action function.
    Sampling, log-probabilities and ratios live in delta space;
    ``env_action`` is the bridge to the env's torque action space."""

    def __init__(self, obs_dim: int, action_dim: int, *, kp, kd, qvel_cols,
                 vel_obs_scale: float = 0.1, act_scale: float = 20.0,
                 device="cuda", **kw):
        super().__init__(obs_dim, action_dim, device=device, **kw)
        dev = self.log_std.device
        # constants of the action map, not parameters: left out of the
        # state dict, so a PD net's state dict is an ActorCritic's
        for name, val, dtype in (("kp", kp, torch.float32),
                                 ("kd", kd, torch.float32),
                                 ("qvel_cols", qvel_cols, torch.int64)):
            self.register_buffer(name, torch.tensor(val, dtype=dtype,
                                                    device=dev),
                                 persistent=False)
        self.vel_obs_scale = float(vel_obs_scale)
        self.act_scale = float(act_scale)
        # the gains as given, in float64: a deployment artifact
        # (rl/extracted_policy.py) stores them unrounded
        self.pd_gains = (np.asarray(kp, np.float64),
                         np.asarray(kd, np.float64))

    def env_action(self, obs, a_delta):
        qvel = obs[..., self.qvel_cols] / self.vel_obs_scale
        return (self.kp * a_delta - self.kd * qvel) / self.act_scale


def make_policy(kind: str, env, net_arch=(256, 128), init_log_std=0.0,
                log_std_min=-4.0, log_std_max=1.0, device="cuda",
                generator: Optional[torch.Generator] = None) -> ActorCritic:
    """Policy factory: "torque" (reference parity) or "pd" (PD-delta).

    PD gains default to the actuator ctrl range (full-scale torque at
    1 rad error) with kd = kp/10, the reference's kp:kd ratio
    (src/mujoco/mocap_util.py:22-24)."""
    kw = dict(net_arch=tuple(net_arch), init_log_std=init_log_std,
              log_std_min=log_std_min, log_std_max=log_std_max,
              device=device, generator=generator)
    if kind == "torque":
        return ActorCritic(env.obs_size, env.action_size, **kw)
    if kind != "pd":
        raise ValueError(f"unknown policy kind: {kind}")
    m = env.model
    hi = np.asarray(m.actuator_ctrlrange[:env.action_size, 1], np.float32)
    # obs column of each actuated joint's scaled qvel: the obs layout is
    # [qpos[7:] (nq-7) | qvel[6:] * scale (nv-6) | ...]
    trnid = np.asarray(m.actuator_trnid).reshape(m.nu, -1)[:, 0]
    dofadr = np.asarray(m.jnt_dofadr)[trnid[:env.action_size]]
    return PDTargetActorCritic(
        env.obs_size, env.action_size,
        kp=[float(x) for x in hi], kd=[float(x) / 10.0 for x in hi],
        qvel_cols=[int((m.nq - 7) + (d - 6)) for d in dofadr],
        vel_obs_scale=env.ENV_CFG.VEL_OBS_SCALE,
        act_scale=float(env.spec.act_scale), **kw)


def env_action(net, obs, action):
    """Map a policy-space action to the env action space (the identity
    for plain torque policies)."""
    if hasattr(net, "env_action"):
        return net.env_action(obs, action)
    return action
