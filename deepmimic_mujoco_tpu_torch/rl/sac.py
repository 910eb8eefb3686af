"""SAC on the card: a device-resident replay buffer, twin critics, a
squashed Gaussian actor with automatic entropy tuning.

The port of the JAX package's ``rl/sac.py`` (reference: src/sac_sb3.py:
20-89, buffer 5M, net_arch [1024, 512]). One iteration steps a batch of
envs ``steps_per_iter`` times under the sampled actor, writing each
transition into a ring buffer that lives on the env's device, then takes
``updates_per_iter`` gradient updates on minibatches drawn from it.

Where the JAX package's libraries differ from torch's defaults, this
module writes the JAX package's form by hand:
- the Linear layers start as flax's ``Dense`` does: a LeCun
  truncated-normal kernel and a zero bias (``dense_init``);
- the three optimizers are optax.adam with its defaults (eps 1e-8), in
  optax's float32 arithmetic (``ppo.Adam``).

Inside one iteration nothing is read back to the host: the buffer's
write position advances by ``n_envs`` a step, so it is a Python int, and
the statistics come back as tensors.

Random draws come from explicit generators held in the state. The four
``draw_*`` methods are the draws a subclass may replace (the parity
tests hand in the JAX package's key chain there): one action noise per
collect step, and the minibatch indices, the next-action noise and the
policy noise once per update.

Spans and counters (``utils/tracing.py``; off, each is a flag check):
``setup.train_state`` (``init``, which allocates the buffer);
``sac.iter``; ``sac.collect`` with ``sac.policy`` and
``sac.buffer_write`` inside it; ``sac.update`` with one
``sac.update_step`` per update. Each update counts ``sac.updates`` (1)
and ``sac.buffer_rows`` (the valid rows it draws from), host numbers
both: nothing is read from the device.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from deepmimic_mujoco_tpu_torch.rl.ppo import Adam
from deepmimic_mujoco_tpu_torch.utils import tracing
from deepmimic_mujoco_tpu_torch.utils.device import resolve_device

# optax.adam's default epsilon (PPO keeps 1e-5, SB3's value)
ADAM_EPS = 1e-8
LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
LOG_ALPHA_MAX = 2.0
BUFFER_FIELDS = ("obs", "action", "reward", "next_obs", "done")


@dataclasses.dataclass
class SACConfig:
    n_envs: int = 256
    buffer_size: int = 1_000_000
    batch_size: int = 1024
    steps_per_iter: int = 32          # env steps collected per iteration
    updates_per_iter: int = 32        # gradient updates per iteration
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    net_arch: tuple = (1024, 512)
    action_scale: float = 1.0
    total_timesteps: int = 10_000_000
    # temperature: a slower lr and a hard floor, so exploration never
    # dies (saturated tanh actions make logp explode, which crushes an
    # unbounded temperature)
    alpha_lr: float = 1e-4
    log_alpha_min: float = -4.6        # alpha >= ~0.01
    # the actor's gradient is zeroed for the first N env steps, so the
    # critic fits the (possibly warm-started) data distribution first
    critic_warmup_steps: int = 0
    # a separate actor lr (None = lr): a distilled warm-started actor
    # wants a gentler rate than the critic
    actor_lr: Optional[float] = None


def dense_init(layer: nn.Linear, generator: Optional[torch.Generator]):
    """flax ``nn.Dense``'s default init: the kernel from
    ``lecun_normal()`` (variance_scaling(1, "fan_in", "truncated_normal"):
    a normal truncated to +-2 std, its std divided by 0.8796... so the
    truncated draw keeps variance 1/fan_in) and a zero bias."""
    std = math.sqrt(1.0 / layer.in_features) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        layer.bias.zero_()


def _dense(n_in, n_out, device, generator):
    layer = nn.Linear(n_in, n_out, device=device)
    dense_init(layer, generator)
    return layer


class Actor(nn.Module):
    """ReLU trunk, then a mean head and a log-std head, the log-std
    clamped to [-20, 2]."""

    def __init__(self, obs_dim: int, action_dim: int,
                 net_arch: Sequence[int] = (1024, 512), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dims = [obs_dim, *net_arch]
        self.trunk = nn.ModuleList(
            _dense(a, b, dev, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.mean = _dense(dims[-1], action_dim, dev, generator)
        self.log_std = _dense(dims[-1], action_dim, dev, generator)

    def forward(self, obs):
        """obs (..., obs_dim) -> (mean, log_std)."""
        x = obs
        for layer in self.trunk:
            x = torch.relu(layer(x))
        return self.mean(x), torch.clamp(self.log_std(x), LOG_STD_MIN,
                                         LOG_STD_MAX)


class Critic(nn.Module):
    """Q(obs, action): a ReLU MLP over their concatenation."""

    def __init__(self, obs_dim: int, action_dim: int,
                 net_arch: Sequence[int] = (1024, 512), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dims = [obs_dim + action_dim, *net_arch, 1]
        self.layers = nn.ModuleList(
            _dense(a, b, dev, generator) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, obs, action):
        x = torch.cat([obs, action], -1)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)[..., 0]


class DoubleCritic(nn.Module):
    """The twin critics: (Q1, Q2) of the same input."""

    def __init__(self, obs_dim: int, action_dim: int,
                 net_arch: Sequence[int] = (1024, 512), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.critics = nn.ModuleList(
            Critic(obs_dim, action_dim, net_arch, device, generator)
            for _ in range(2))

    def forward(self, obs, action):
        return self.critics[0](obs, action), self.critics[1](obs, action)


def squash_sample(mean, log_std, noise):
    """a = tanh(mean + std * noise) and its log-probability under the
    squashed Gaussian (the tanh correction keeps the JAX package's 1e-6
    inside the log). ``noise`` is a standard normal draw of mean's
    shape, drawn by the caller."""
    std = torch.exp(log_std)
    z = mean + std * noise
    a = torch.tanh(z)
    logp = (-0.5 * ((z - mean) / std) ** 2 - log_std
            - 0.5 * math.log(2 * math.pi)).sum(-1)
    logp = logp - torch.log(1 - a ** 2 + 1e-6).sum(-1)
    return a, logp


@dataclasses.dataclass
class SACState:
    """Everything an iteration reads and writes. ``buffer`` holds one
    tensor per field (obs, the squashed action before ``action_scale``,
    reward, next_obs, done as float), ``buffer_size`` rows each;
    ``buf_pos`` is the next row written and ``buf_full`` whether the
    ring has wrapped. ``gens`` are the generators of the action noise
    ("act"), the minibatch indices ("idx"), the next-action and policy
    noises ("next", "pi") and the envs' RSI reset draws ("rsi")."""
    actor: Actor
    critic: DoubleCritic
    target_critic: DoubleCritic
    log_alpha: torch.Tensor       # 0-d leaf
    opt_actor: Adam
    opt_critic: Adam
    opt_alpha: Adam
    env_states: Any
    last_obs: torch.Tensor
    buffer: Dict[str, torch.Tensor]
    buf_pos: int
    buf_full: bool
    gens: Dict[str, torch.Generator]
    global_step: int
    ep_return: torch.Tensor       # (n_envs,) running episode accounting
    ep_length: torch.Tensor


class SACStats(NamedTuple):
    """One iteration's statistics, as tensors, in the JAX package's
    order."""
    mean_reward: torch.Tensor
    critic_loss: torch.Tensor     # mean over the iteration's updates
    actor_loss: torch.Tensor
    ep_return_sum: torch.Tensor   # sum of completed episode returns
    ep_count: torch.Tensor
    ep_len_sum: torch.Tensor
    alpha: torch.Tensor           # after the iteration


def buffer_bytes(buffer: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in buffer.values())


class SAC:
    """Trainer bound to a functional env (``DPEnv``)."""

    def __init__(self, env, cfg: Optional[SACConfig] = None):
        self.env = env
        self.cfg = cfg or SACConfig()
        self.device = env.device
        self.target_entropy = -float(env.action_size)

    # ---- initialization -------------------------------------------------
    def make_actor(self, generator: Optional[torch.Generator] = None):
        """The actor, initialized on the CPU from ``generator`` (so the
        card and the CPU start from the same weights), on the env's
        device."""
        return Actor(self.env.obs_size, self.env.action_size,
                     tuple(self.cfg.net_arch), device="cpu",
                     generator=generator).to(self.device)

    def make_critic(self, generator: Optional[torch.Generator] = None):
        return DoubleCritic(self.env.obs_size, self.env.action_size,
                            tuple(self.cfg.net_arch), device="cpu",
                            generator=generator).to(self.device)

    @tracing.spanned("setup.train_state")
    def init(self, seed: int = 0, init_actor=None) -> SACState:
        """A fresh state; ``init_actor`` (a state dict, e.g. distilled
        from a PPO policy) replaces the actor's initial weights."""
        cfg = self.cfg
        dev = self.device
        g = torch.Generator().manual_seed(seed)
        actor = self.make_actor(g)
        critic = self.make_critic(g)
        if init_actor is not None:
            actor.load_state_dict(init_actor)
        # a copy, never an alias: the target moves only by Polyak steps
        target = copy.deepcopy(critic).requires_grad_(False)
        log_alpha = torch.zeros((), device=dev, requires_grad=True)
        gens = {name: torch.Generator(device=dev).manual_seed(seed * 8 + i + 1)
                for i, name in enumerate(("act", "idx", "next", "pi",
                                          "rsi"))}
        with torch.no_grad():
            env_states, obs = self.env.reset(cfg.n_envs,
                                             generator=gens["rsi"])
        n, o, a = cfg.buffer_size, self.env.obs_size, self.env.action_size
        zeros = lambda *shape: torch.zeros(shape, device=dev)
        buffer = dict(obs=zeros(n, o), action=zeros(n, a), reward=zeros(n),
                      next_obs=zeros(n, o), done=zeros(n))
        return SACState(
            actor=actor, critic=critic, target_critic=target,
            log_alpha=log_alpha,
            opt_actor=Adam(actor.parameters(), eps=ADAM_EPS),
            opt_critic=Adam(critic.parameters(), eps=ADAM_EPS),
            opt_alpha=Adam([log_alpha], eps=ADAM_EPS),
            env_states=env_states, last_obs=obs, buffer=buffer, buf_pos=0,
            buf_full=False, gens=gens, global_step=0,
            ep_return=torch.zeros(cfg.n_envs, device=dev),
            ep_length=torch.zeros(cfg.n_envs, dtype=torch.int64,
                                  device=dev))

    # ---- the draws --------------------------------------------------------
    def _normal(self, gen, like):
        return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                           device=like.device)

    def draw_action_noise(self, s: SACState, mean) -> torch.Tensor:
        return self._normal(s.gens["act"], mean)

    def draw_idx(self, s: SACState, valid: int) -> torch.Tensor:
        return torch.randint(0, valid, (self.cfg.batch_size,),
                             generator=s.gens["idx"], device=self.device)

    def draw_next_noise(self, s: SACState, mean) -> torch.Tensor:
        return self._normal(s.gens["next"], mean)

    def draw_pi_noise(self, s: SACState, mean) -> torch.Tensor:
        return self._normal(s.gens["pi"], mean)

    # ---- one iteration ----------------------------------------------------
    @tracing.spanned("sac.policy")
    def policy(self, s: SACState, obs):
        """(action, log-probability) sampled from the actor at ``obs``:
        the squashed action before ``action_scale``, its noise drawn by
        ``draw_action_noise``."""
        mean, log_std = s.actor(obs)
        return squash_sample(mean, log_std, self.draw_action_noise(s, mean))

    @tracing.spanned("sac.buffer_write")
    def write(self, buf: Dict[str, torch.Tensor], idx, rows):
        """``rows`` (one tensor per field of ``BUFFER_FIELDS``) into the
        ring buffer's rows ``idx``."""
        for name, val in zip(BUFFER_FIELDS, rows):
            buf[name][idx] = val

    @tracing.spanned("sac.collect")
    def collect(self, s: SACState) -> torch.Tensor:
        """``steps_per_iter`` steps of step_auto_reset under the sampled
        actor, each written into the ring buffer at ``(pos + arange(B))
        % buffer_size``. Advances ``s``'s env, buffer and episode fields
        (``buf_full`` once the ring has wrapped) and returns the
        (steps, 4) per-step stats."""
        cfg = self.cfg
        B, n = cfg.n_envs, cfg.buffer_size
        states, obs, pos = s.env_states, s.last_obs, s.buf_pos
        ep_ret, ep_len = s.ep_return, s.ep_length
        rows = torch.arange(B, device=self.device)
        stats = []
        with torch.no_grad():
            for _ in range(cfg.steps_per_iter):
                a, _ = self.policy(s, obs)
                states, out = self.env.step_auto_reset(
                    states, a * cfg.action_scale, s.gens["rsi"])
                done_f = out.done.to(torch.float32)
                self.write(s.buffer, (pos + rows) % n,
                           (obs, a, out.reward, out.obs, done_f))
                ep_ret = ep_ret + out.reward
                ep_len = ep_len + 1
                stats.append(torch.stack([
                    out.reward.mean(), (ep_ret * done_f).sum(), done_f.sum(),
                    (ep_len * out.done).sum().to(torch.float32)]))
                ep_ret = torch.where(out.done, 0.0, ep_ret)
                ep_len = torch.where(out.done, 0, ep_len)
                obs = out.obs
                pos = (pos + B) % n
        s.buf_full = s.buf_full or pos < s.buf_pos
        s.env_states, s.last_obs, s.buf_pos = states, obs, pos
        s.ep_return, s.ep_length = ep_ret, ep_len
        return torch.stack(stats)

    @staticmethod
    def _step(opt: Adam, params, grads, lr: float):
        for p, g in zip(params, grads):
            p.grad = g
        opt.step(lr)

    def next_action(self, s: SACState, b_next):
        """(a', logp(a')): the next action sampled from the actor at the
        next obs with ``draw_next_noise``."""
        mean_n, log_std_n = s.actor(b_next)
        return squash_sample(mean_n, log_std_n,
                             self.draw_next_noise(s, mean_n))

    def q_target(self, s: SACState, b_rew, b_next, b_done, alpha):
        """The critics' regression target: r + gamma (1 - done) (min of
        the target critics at (next obs, a') - alpha logp(a')), a' from
        ``next_action``."""
        with torch.no_grad():
            a_next, logp_next = self.next_action(s, b_next)
            q1t, q2t = s.target_critic(b_next, a_next)
            return b_rew + self.cfg.gamma * (1 - b_done) * (
                torch.minimum(q1t, q2t) - alpha * logp_next)

    def polyak(self, s: SACState):
        """The target critics' Polyak step: target = (1 - tau) target +
        tau critic."""
        tau = self.cfg.tau
        with torch.no_grad():
            tparams = list(s.target_critic.parameters())
            torch._foreach_mul_(tparams, 1 - tau)
            torch._foreach_add_(tparams,
                                [p.detach() for p in s.critic.parameters()],
                                alpha=tau)

    @tracing.spanned("sac.update_step")
    def update_step(self, s: SACState, valid: int, warm: float):
        """One gradient update on a minibatch drawn from the first
        ``valid`` rows; returns (critic loss, actor loss). Order: the
        Q target from the pre-update actor and the target critic at the
        alpha of the update's start; the critic step; the actor loss
        through the updated critic (gradients to the actor only, times
        ``warm``); the alpha loss on that logp, detached; log_alpha
        clamped after its step; the Polyak step of the target."""
        cfg = self.cfg
        tracing.count("sac.updates", 1)
        tracing.count("sac.buffer_rows", valid)
        buf = s.buffer
        idx = self.draw_idx(s, valid)
        b_obs, b_act, b_rew, b_next, b_done = (
            buf[k][idx] for k in BUFFER_FIELDS)
        alpha = s.log_alpha.detach().exp()
        q_target = self.q_target(s, b_rew, b_next, b_done, alpha)

        cparams = list(s.critic.parameters())
        q1, q2 = s.critic(b_obs, b_act)
        closs = ((q1 - q_target) ** 2).mean() + ((q2 - q_target) ** 2).mean()
        self._step(s.opt_critic, cparams, torch.autograd.grad(closs, cparams),
                   cfg.lr)

        aparams = list(s.actor.parameters())
        mean, log_std = s.actor(b_obs)
        a, logp = squash_sample(mean, log_std, self.draw_pi_noise(s, mean))
        q1, q2 = s.critic(b_obs, a)
        aloss = (alpha * logp - torch.minimum(q1, q2)).mean()
        agrads = torch.autograd.grad(aloss, aparams)
        # critic warmup zeroes the GRADIENT, so Adam's count and moments
        # advance with zeros (a skipped step would release a stale
        # momentum burst when the warmup ends)
        torch._foreach_mul_(agrads, warm)
        self._step(s.opt_actor, aparams, agrads,
                   cfg.actor_lr if cfg.actor_lr is not None else cfg.lr)

        alloss = -(s.log_alpha.exp()
                   * (logp.detach() + self.target_entropy)).mean()
        self._step(s.opt_alpha, [s.log_alpha],
                   torch.autograd.grad(alloss, [s.log_alpha]), cfg.alpha_lr)
        with torch.no_grad():
            s.log_alpha.clamp_(cfg.log_alpha_min, LOG_ALPHA_MAX)
        self.polyak(s)
        return closs.detach(), aloss.detach()

    @tracing.spanned("sac.update")
    def update(self, s: SACState, valid: int, warm: float) -> torch.Tensor:
        """``updates_per_iter`` updates (``update_step``) on minibatches
        drawn from the first ``valid`` rows, the actor's gradient times
        ``warm``; returns the (updates, 2) critic and actor losses."""
        return torch.stack([torch.stack(self.update_step(s, valid, warm))
                            for _ in range(self.cfg.updates_per_iter)])

    @tracing.spanned("sac.iter")
    def train_iter(self, s: SACState):
        """One iteration (collect + updates); advances ``s`` in place and
        returns (s, SACStats)."""
        cfg = self.cfg
        stats = self.collect(s)
        valid = cfg.buffer_size if s.buf_full else max(s.buf_pos, 1)
        # the warmup test reads global_step at the iteration's start
        warm = float(s.global_step >= cfg.critic_warmup_steps)
        losses = self.update(s, valid, warm)
        s.global_step += cfg.n_envs * cfg.steps_per_iter
        return s, SACStats(
            mean_reward=stats[:, 0].mean(), critic_loss=losses[:, 0].mean(),
            actor_loss=losses[:, 1].mean(), ep_return_sum=stats[:, 1].sum(),
            ep_count=stats[:, 2].sum(), ep_len_sum=stats[:, 3].sum(),
            alpha=s.log_alpha.detach().exp())

    # ---- host loop -------------------------------------------------------
    def train(self, total_timesteps: Optional[int] = None, seed: int = 0,
              verbose: bool = True, callback=None, init_actor=None):
        cfg = self.cfg
        total = total_timesteps or cfg.total_timesteps
        s = self.init(seed, init_actor=init_actor)
        per_iter = cfg.n_envs * cfg.steps_per_iter
        t0 = time.time()
        for it in range(max(total // per_iter, 1)):
            s, stats = self.train_iter(s)
            if callback is not None:
                callback(it, s, stats)
            if verbose and it % 10 == 0:
                r, closs, aloss, eps, epc, epl, alpha = (float(x)
                                                          for x in stats)
                sps = (it + 1) * per_iter / (time.time() - t0)
                print(f"iter {it:5d} step {(it + 1) * per_iter:>11,} "
                      f"sps {sps:>10,.0f} r {r:.3f} "
                      f"ep_rew {eps / max(epc, 1.0):8.2f} "
                      f"ep_len {epl / max(epc, 1.0):6.1f} "
                      f"closs {closs:.3f} aloss {aloss:.3f} "
                      f"alpha {alpha:.3f}", flush=True)
        return s

    # ---- inference --------------------------------------------------------
    def act(self, actor: Actor, obs, deterministic: bool = True,
            generator: Optional[torch.Generator] = None):
        """The env action: tanh(mean) (or a squashed sample) times
        ``action_scale``."""
        with torch.no_grad():
            mean, log_std = actor(obs)
            if deterministic:
                return torch.tanh(mean) * self.cfg.action_scale
            noise = torch.randn(mean.shape, generator=generator,
                                dtype=mean.dtype, device=mean.device)
            return squash_sample(mean, log_std, noise)[0] * \
                self.cfg.action_scale
