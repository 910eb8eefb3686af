"""The actor-critic: SB3's MlpPolicy layout (separate tanh trunks,
orthogonal init: gain sqrt(2) on hidden layers, 0.01 on the policy
head, 1 on the value head; zero biases; a state-independent log-std),
as plain tensors in a dict keyed like the port's ``named_parameters``.
"""
import math

import torch
from torch import nn


def init_params(obs_dim: int, act_dim: int, net_arch, init_log_std: float,
                seed: int) -> dict:
    """The weights the seed gives: orthogonal draws from a CPU generator
    seeded with ``seed``, in float32, the actor's layers first, then the
    critic's."""
    g = torch.Generator().manual_seed(seed)
    params = {"log_std": torch.full((act_dim,), float(init_log_std))}
    for head, out_dim, head_gain in (("actor", act_dim, 0.01),
                                     ("critic", 1, 1.0)):
        dims = [obs_dim, *net_arch, out_dim]
        gains = [math.sqrt(2)] * len(net_arch) + [head_gain]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.empty(b, a)
            nn.init.orthogonal_(w, gain=gains[i], generator=g)
            params[f"{head}.{i}.weight"] = w
            params[f"{head}.{i}.bias"] = torch.zeros(b)
    return params


def _trunk(params, head, x):
    n = sum(1 for k in params if k.startswith(head) and k.endswith("weight"))
    for i in range(n):
        x = x @ params[f"{head}.{i}.weight"].T + params[f"{head}.{i}.bias"]
        if i < n - 1:
            x = torch.tanh(x)
    return x


def forward(params, obs, log_std_min: float, log_std_max: float):
    """(mean, log_std, value) of ``obs`` (N, obs_dim)."""
    mean = _trunk(params, "actor", obs)
    value = _trunk(params, "critic", obs)[..., 0]
    log_std = torch.clamp(params["log_std"], log_std_min, log_std_max)
    return mean, log_std, value


def gaussian_logp(action, mean, log_std):
    z = (action - mean) / torch.exp(log_std)
    return (-0.5 * z ** 2 - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)


def gaussian_entropy(log_std):
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)
