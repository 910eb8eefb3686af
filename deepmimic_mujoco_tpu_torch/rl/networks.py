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

import torch
from torch import nn

from deepmimic_mujoco_tpu_torch.utils.device import resolve_device


def clip_preserve_inward(x, lo, hi):
    """Forward of the JAX package's inward-preserving clip: the value is
    ``clip(x, lo, hi)``. Its custom gradient comes with training."""
    return torch.clamp(x, lo, hi)


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
