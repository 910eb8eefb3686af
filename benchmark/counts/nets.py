"""Flops of the policy and value MLPs (tanh trunks, separate actor and
critic, as the SB3 MlpPolicy the port follows).

A dense layer costs 2 x fan_in x fan_out flops per sample (a
multiply-add is 2); biases, tanh and the Gaussian's arithmetic are not
counted. A training sample costs about 3 forwards (the forward, and the
backward's two products per layer)."""


def mlp_flops(sizes) -> int:
    """Flops of one sample through dense layers of ``sizes`` (input
    width first, output width last)."""
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def actor_critic_flops(obs_dim: int, act_dim: int, net_arch) -> int:
    """One forward of the actor and the critic for one sample."""
    return (mlp_flops([obs_dim, *net_arch, act_dim])
            + mlp_flops([obs_dim, *net_arch, 1]))


def train_sample_flops(obs_dim: int, act_dim: int, net_arch) -> int:
    """One sample's forward and backward in the update."""
    return 3 * actor_critic_flops(obs_dim, act_dim, net_arch)
