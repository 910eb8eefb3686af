"""SAC's actor, twin critics and update (Haarnoja et al. 2018, as SB3's
SAC trains it), as plain tensors in a dict keyed like the port's
``named_parameters``: ``actor.trunk.<i>``, ``actor.mean``,
``actor.log_std`` and ``critic.critics.<c>.layers.<i>``, each with its
``.weight`` and ``.bias``.

- The actor: a ReLU trunk, then a mean head and a log-std head, the
  log-std clamped to [-20, 2]. A critic: a ReLU MLP over (obs, action)
  to one Q. The twin critics' target is a Polyak copy.
- The squashed Gaussian: a = tanh(mean + std noise), its log-probability
  with the tanh correction log(1 - a^2 + 1e-6).
- One update: the Q target from the target critics at (next obs, a'),
  a' drawn from the actor; the critic loss (the sum of the two critics'
  mean squared errors) and its Adam step; the actor loss through the
  critics after their step, its gradient times ``warm``, its Adam step;
  the temperature's loss on the actor's log-probability and its Adam
  step; log alpha clamped; the Polyak step.

Where it departs from SB3's SAC, it does as the port does:
- the temperature has its own learning rate (``alpha_lr``) and a floor:
  log alpha is clamped to [``log_alpha_min``, 2] after each of its steps
  (SB3: the nets' rate, no clamp), and it is stepped after the actor,
  not before the critic;
- the critic loss is the sum of the two mean squared errors (SB3 halves
  it);
- the layers start as flax's ``Dense`` does: a LeCun truncated-normal
  kernel (a normal cut at 2 std, its std divided by 0.8796... so the cut
  draw keeps variance 1 / fan_in) and a zero bias (SB3: torch's default
  init);
- the three optimizers are optax.adam (eps 1e-8) in optax's arithmetic,
  the form of ``reference/ppo.py``: bias corrections 1 - b^t in float32
  with b rounded to float32, p -= lr mu_hat / (sqrt(nu_hat) + eps) (SB3:
  torch.optim.Adam).

``hp`` is the traffic file's ``sac`` block (``gamma``, ``tau``, ``lr``,
``alpha_lr``, ``log_alpha_min``; ``actor_lr`` where the actor has a rate
of its own).
"""
import math

import numpy as np
import torch
from torch import nn

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
LOG_ALPHA_MAX = 2.0
TRUNCATED_STD = .87962566103423978
ADAM_EPS = 1e-8


def init_params(obs_dim: int, act_dim: int, net_arch, seed: int,
                critics: int = 2) -> dict:
    """The weights the seed gives, in float32: truncated-normal draws from
    a CPU generator seeded with ``seed``, the actor's layers first (trunk,
    mean, log-std), then each critic's."""
    g = torch.Generator().manual_seed(seed)
    params = {}

    def dense(name, n_in, n_out):
        std = math.sqrt(1.0 / n_in) / TRUNCATED_STD
        w = torch.empty(n_out, n_in)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
        params[f"{name}.weight"] = w
        params[f"{name}.bias"] = torch.zeros(n_out)

    dims = [obs_dim, *net_arch]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        dense(f"actor.trunk.{i}", a, b)
    dense("actor.mean", dims[-1], act_dim)
    dense("actor.log_std", dims[-1], act_dim)
    dims = [obs_dim + act_dim, *net_arch, 1]
    for c in range(critics):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            dense(f"critic.critics.{c}.layers.{i}", a, b)
    return params


def _dense(p, name, x):
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def actor(p, obs):
    """(mean, log_std) at ``obs`` (N, obs_dim)."""
    x, i = obs, 0
    while f"actor.trunk.{i}.weight" in p:
        x = torch.relu(_dense(p, f"actor.trunk.{i}", x))
        i += 1
    return _dense(p, "actor.mean", x), torch.clamp(
        _dense(p, "actor.log_std", x), LOG_STD_MIN, LOG_STD_MAX)


def critics(p, obs, action) -> tuple:
    """Each critic's Q at (obs, action), (N,) each."""
    out, c = [], 0
    while f"critic.critics.{c}.layers.0.weight" in p:
        x, i = torch.cat([obs, action], -1), 0
        while f"critic.critics.{c}.layers.{i + 1}.weight" in p:
            x = torch.relu(_dense(p, f"critic.critics.{c}.layers.{i}", x))
            i += 1
        out.append(_dense(p, f"critic.critics.{c}.layers.{i}", x)[..., 0])
        c += 1
    return tuple(out)


def squash_sample(mean, log_std, noise):
    """(tanh(mean + std noise), its log-probability under the squashed
    Gaussian)."""
    std = torch.exp(log_std)
    z = mean + std * noise
    a = torch.tanh(z)
    logp = (-0.5 * ((z - mean) / std) ** 2 - log_std
            - 0.5 * math.log(2 * math.pi)).sum(-1)
    return a, logp - torch.log(1 - a ** 2 + 1e-6).sum(-1)


# the float32 conditioning a row's log-probability needs to be compared,
# in every dim: 1 - a^2 >= COND (float32's rounding of a near 1, 2^-24,
# moves log(1 - a^2 + 1e-6) by up to 2^-23 / (1 - a^2): 1.2e-5 at COND,
# 0.1 where a rounds to +-1) and std >= COND max(1, |mean|) ((z - mean)
# / std carries float32's rounding of z = mean + std noise, 2^-24
# |mean| / std of the noise: 6e-6 at COND, all of it at the log-std
# floor, -20)
COND = 1e-2


def conditioned(mean, log_std, action):
    """Rows (of a sample in float64) whose log-probability float32 can
    carry (``COND``)."""
    return (((1 - action ** 2) >= COND)
            & (torch.exp(log_std) >= COND * mean.abs().clamp(min=1.0))
            ).all(-1)


def _f32(x) -> float:
    return float(np.float32(x))


class Adam:
    """optax.adam over the leaves ``names`` of a dict, in optax's
    arithmetic."""

    def __init__(self, params: dict, names, eps: float = ADAM_EPS,
                 b1: float = 0.9, b2: float = 0.999):
        self.names, self.eps, self.b1, self.b2 = list(names), eps, b1, b2
        self.count = 0
        self.mu = {k: torch.zeros_like(params[k]) for k in self.names}
        self.nu = {k: torch.zeros_like(params[k]) for k in self.names}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float):
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1 = _f32(1.0 - np.float32(b1) ** np.float32(self.count))
        bc2 = _f32(1.0 - np.float32(b2) ** np.float32(self.count))
        for k in self.names:
            g = grads[k]
            self.mu[k] = self.mu[k] + (g - self.mu[k]) * (1.0 - b1)
            self.nu[k] = b2 * self.nu[k] + (1.0 - b2) * g * g
            params[k] -= lr * (self.mu[k] / bc1) / (
                torch.sqrt(self.nu[k] / bc2) + self.eps)


class State:
    """The trained quantities: ``params`` (actor and critics, leaves that
    take gradients), ``target`` (the target critics, keyed like the
    critics; default: a copy of the critics), ``log_alpha`` and the
    three optimizers (``adam``: for each of ``actor``, ``critic`` and
    ``alpha``, its (count, mu, nu) keyed like its leaves, ``log_alpha``
    for alpha; default: fresh)."""

    def __init__(self, params: dict, log_alpha=0.0, target: dict = None,
                 adam: dict = None):
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in params.items()}
        self.target = {k: v.clone() for k, v in (target or params).items()
                       if k.startswith("critic.")}
        like = next(iter(params.values()))
        self.log_alpha = torch.as_tensor(
            log_alpha, dtype=like.dtype, device=like.device).clone(
            ).requires_grad_(True)
        self.actor_names = [k for k in params if k.startswith("actor.")]
        self.critic_names = list(self.target)
        self.opt_actor = Adam(self.params, self.actor_names)
        self.opt_critic = Adam(self.params, self.critic_names)
        self.opt_alpha = Adam({"log_alpha": self.log_alpha}, ["log_alpha"])
        for name, opt in (("actor", self.opt_actor),
                          ("critic", self.opt_critic),
                          ("alpha", self.opt_alpha)):
            if adam is not None:
                opt.count, mu, nu = adam[name]
                opt.mu = {k: mu[k].to(like) for k in opt.names}
                opt.nu = {k: nu[k].to(like) for k in opt.names}


def q_target(st: State, reward, next_obs, done, noise, alpha, gamma: float,
             logp_fed=None):
    """(the critics' regression target, the next action's (mean,
    log_std, action, log-probability) it was drawn with, and the rows
    whose log-probability float32 can carry (``conditioned``)). Where
    ``logp_fed`` is given (a candidate's next-action log-probability),
    it takes the place of the target's own on the other rows; reward,
    gamma, done and the target critics stay the target's own."""
    with torch.no_grad():
        mean, log_std = actor(st.params, next_obs)
        a, logp = squash_sample(mean, log_std, noise)
        kept = conditioned(mean, log_std, a)
        used = logp if logp_fed is None else torch.where(
            kept, logp, logp_fed.to(logp))
        q = torch.minimum(*critics(st.target, next_obs, a))
        return (reward + gamma * (1 - done) * (q - alpha * used),
                (mean, log_std, a, logp), kept)


def update(st: State, batch, noise_next, noise_pi, hp: dict,
           warm: float = 1.0, regress_to=None, logp_fed=None) -> dict:
    """One update of ``st`` in place on ``batch`` = (obs, action, reward,
    next_obs, done), with the next-action and policy noises given; the
    critics regress to ``regress_to`` where given (a Q target computed
    elsewhere), else to their own ``q_target`` (``logp_fed``: as
    ``q_target`` takes it). Returns that ``q_target`` with the
    ``next_sample`` (mean, log_std, action, log-probability) of the next
    action, its
    ``conditioned`` rows, ``critic_loss``, ``actor_loss``,
    ``alpha_loss`` and the gradients each optimizer got
    (``critic_grad``, ``actor_grad`` after ``warm``, ``alpha_grad``)."""
    obs, action, reward, next_obs, done = batch
    p = st.params
    alpha = st.log_alpha.detach().exp()
    qt, nxt, kept = q_target(st, reward, next_obs, done, noise_next, alpha,
                             hp["gamma"], logp_fed)
    y = qt if regress_to is None else regress_to

    q1, q2 = critics(p, obs, action)
    closs = ((q1 - y) ** 2).mean() + ((q2 - y) ** 2).mean()
    g_c = dict(zip(st.critic_names, torch.autograd.grad(
        closs, [p[k] for k in st.critic_names])))
    st.opt_critic.step(p, g_c, hp["lr"])

    mean, log_std = actor(p, obs)
    a, logp = squash_sample(mean, log_std, noise_pi)
    aloss = (alpha * logp - torch.minimum(*critics(p, obs, a))).mean()
    g_a = {k: g * warm for k, g in zip(st.actor_names, torch.autograd.grad(
        aloss, [p[k] for k in st.actor_names]))}
    st.opt_actor.step(p, g_a, hp.get("actor_lr") or hp["lr"])

    alloss = -(st.log_alpha.exp() * (logp.detach()
                                     - float(action.shape[-1]))).mean()
    g_alpha = torch.autograd.grad(alloss, [st.log_alpha])[0]
    st.opt_alpha.step({"log_alpha": st.log_alpha}, {"log_alpha": g_alpha},
                      hp["alpha_lr"])
    with torch.no_grad():
        st.log_alpha.clamp_(hp["log_alpha_min"], LOG_ALPHA_MAX)
        tau = hp["tau"]
        for k in st.critic_names:
            st.target[k] = st.target[k] * (1 - tau) + tau * p[k].detach()
    return dict(q_target=qt, next_sample=nxt, conditioned=kept,
                critic_loss=float(closs.detach()),
                actor_loss=float(aloss.detach()),
                alpha_loss=float(alloss.detach()), critic_grad=g_c,
                actor_grad=g_a, alpha_grad=g_alpha)
