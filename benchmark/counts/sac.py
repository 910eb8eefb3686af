"""Flops of SAC's networks (a ReLU actor with a mean and a log-std head,
twin ReLU critics over (obs, action)), as autograd computes them in one
collect step and one update.

A dense layer costs 2 x fan_in x fan_out flops a sample forward (a
multiply-add is 2), as much again for its weight's gradient, and as much
again for its input's gradient where autograd needs that: never at a
network's first layer when its input is data, always where the input
carries the actor's action. Biases, ReLU, the squashed Gaussian, the
losses, Adam and the Polyak step are not counted.

One update, a sample:
- the Q target: the actor forward at the next obs, each target critic
  forward;
- the critic step: each critic forward, its weights' gradients and its
  inputs' gradients past the first layer;
- the actor step: the actor forward, its weights' gradients and its
  inputs' gradients past the first layer; each critic forward and its
  inputs' gradients through every layer down to the action (its weights
  take no gradient there)."""


def mlp_flops(sizes) -> int:
    """Forward flops of one sample through dense layers of ``sizes``
    (input width first, output width last)."""
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def actor_flops(obs_dim: int, act_dim: int, net_arch) -> int:
    """One sample through the actor: the trunk and both heads (one env's
    sampled action in a collect step)."""
    return (mlp_flops([obs_dim, *net_arch])
            + 2 * mlp_flops([net_arch[-1], act_dim]))


def critic_flops(obs_dim: int, act_dim: int, net_arch) -> int:
    """One sample through one critic."""
    return mlp_flops([obs_dim + act_dim, *net_arch, 1])


def update_sample_flops(obs_dim: int, act_dim: int, net_arch,
                        critics: int = 2) -> int:
    """One minibatch sample of one update."""
    a = actor_flops(obs_dim, act_dim, net_arch)
    a_first = 2 * obs_dim * net_arch[0]
    c = critic_flops(obs_dim, act_dim, net_arch)
    c_first = 2 * (obs_dim + act_dim) * net_arch[0]
    target = a + critics * c
    critic_step = critics * (3 * c - c_first)
    actor_step = 3 * a - a_first + critics * 2 * c
    return target + critic_step + actor_step
