"""PPO on the card: rollout -> GAE -> clipped update, in torch.

The port of the JAX package's ``rl/ppo.py``. One iteration steps a batch
of envs ``horizon`` times under a sampled policy (``step_auto_reset`` of
a ``DPEnv`` or a ``DPCombinedEnv``), computes GAE with the training-only
alive/velocity shaping and its anneal, then runs ``epochs`` passes of
clipped-surrogate updates over minibatches of the flattened rollout,
with value clipping, the per-minibatch advantage-std floor, the log-std
bounds (``networks.clip_preserve_inward``), the KL guard and the
adaptive lr-by-KL controller. With a combined env whose
``HANDOFF_BUFFER_FRAC`` is above 0, the rollout carries the on-policy
handoff buffer: each step captures the states of the envs that just left
GETUP for locomotion, and resets draw from it.

Where torch's defaults differ from the JAX package's, this module writes
the JAX package's form by hand:
- the advantage std is the population std (``unbiased=False``);
- gradients are clipped by global norm as ``optax.clip_by_global_norm``
  does it: scaled by ``max_norm / norm`` only when ``norm >= max_norm``;
- Adam's bias corrections are optax's, in float32 (``Adam``);
- the linear lr schedule counts optimizer updates (``optax.
  linear_schedule``), and ``lr_scale`` scales the Adam step, which is
  the same as scaling optax's Adam update.

The KL guard breaks out of the remaining epochs' updates, which is what
the JAX package's masked no-op updates amount to. Its logged losses are
means over every epoch, masked ones included (evaluated at the held
params on their own permutations), so the port evaluates those epochs'
losses without gradients and logs the same means.

Random draws come from explicit generators held in the train state:
action noise, the minibatch permutations and the envs' RSI reset frames.
``draw_noise`` and ``draw_perm`` are the two draws a subclass may replace
(the parity tests hand in the JAX package's draws there).

Data parallelism (``parallel/mesh.py``): a train state placed by
``shard_train_state`` carries its mesh, and ``train_iter`` then runs on
this rank's slice of the env batch with every read across envs made an
explicit collective, so that it computes what the unsharded iteration
does:
- every draw is the global batch's draw from the replicated generators,
  and the rank keeps its slice (a forced draw is the global draw);
- the handoff buffer is written from the rows of every rank, gathered
  in env order, so every rank holds the unsharded buffer;
- the rollout stats are summed (the overflow: maxed) over the ranks;
- the trajectory is gathered once, before it is flattened, so flat index
  ``t * n_envs + e`` names the unsharded sample; each minibatch of the
  global permutation is split into W equal parts by position, each
  rank's loss normalizes its part's advantages by the whole minibatch's
  mean and std, and the gradients are averaged over the ranks in one
  all_reduce of one flat buffer per minibatch step, so the clip and Adam
  run on the same gradients on every rank and the params stay equal;
- the losses are averaged over the ranks before the KL guard and the lr
  controller read them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from deepmimic_mujoco_tpu_torch.parallel.mesh import data_sharding
from deepmimic_mujoco_tpu_torch.rl import networks


@dataclasses.dataclass
class PPOConfig:
    # reference hyperparams (src/sb3_ppo.py:253-265), env count scaled
    # for batched envs
    n_envs: int = 1024
    horizon: int = 64
    minibatch_size: int = 4096
    epochs: int = 20
    lr: float = 4e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    # SB3-style KL guard: after an epoch whose mean approximate KL
    # exceeds 1.5*target_kl, the remaining epochs take no update (the
    # first epoch always applies)
    target_kl: Optional[float] = None
    # adaptive lr-by-KL: the lr scale is multiplied by 0.7 when an
    # iteration's epoch-1 KL exceeds 1.5*target_kl and by 1.05 when it
    # stays under 0.5*target_kl, clamped to [lr_min_scale, 1]
    adaptive_lr_kl: bool = False
    lr_min_scale: float = 0.02
    # linear lr decay to lr*lr_final_frac over total_timesteps
    lr_final_frac: float = 1.0
    # value clipping around the rollout value (SB3 clip_range_vf)
    clip_vf: Optional[float] = None
    # floor on the per-minibatch advantage std
    adv_std_floor: float = 1e-3
    # bounds on the state-independent log-std parameter
    log_std_min: float = -4.0
    log_std_max: float = 1.0
    adam_eps: float = 1e-5
    # "torque" (reference parity) or "pd" (networks.PDTargetActorCritic)
    policy: str = "torque"
    # training-only survival shaping inside GAE, linearly annealed to 0
    # over alive_bonus_decay_steps global env steps; the env reward and
    # every logged metric stay the true imitation reward
    alive_bonus: float = 0.0
    alive_bonus_decay_steps: int = 0
    # root planar-velocity-match shaping (StepOut.vel_match), annealed on
    # the same schedule
    vel_shaping: float = 0.0
    init_log_std: float = 0.0
    net_arch: tuple = (256, 128)
    total_timesteps: int = 500_000_000
    # capacity of the on-policy handoff buffer (combined env only; armed
    # when env.ENV_CFG.HANDOFF_BUFFER_FRAC > 0): physical states captured
    # at GETUP -> locomotion transitions during the rollout, fed back as
    # reset states
    handoff_buffer_cap: int = 4096


@dataclasses.dataclass
class TrainState:
    """Everything an iteration reads and writes. ``net`` holds the params
    and ``opt`` the Adam state over them (its ``count`` of updates drives
    the lr schedule); ``gens`` are the generators of the action noise
    ("act"), the minibatch permutations ("perm") and the RSI reset draws
    ("rsi"); ``handoff_buf`` is the combined env's on-policy handoff
    buffer (None when unused); ``mesh`` is the data-parallel mesh the
    state was placed on (``parallel.shard_train_state``; None when
    unsharded)."""
    net: torch.nn.Module
    opt: Adam
    env_states: Any
    last_obs: torch.Tensor
    gens: Dict[str, torch.Generator]
    global_step: int
    ep_return: torch.Tensor     # (n_envs,) running episode accounting
    ep_length: torch.Tensor
    lr_scale: float             # adaptive lr-by-KL state (1.0 when off)
    handoff_buf: Any = None
    mesh: Any = None


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    shaping: torch.Tensor    # extra training-only reward (0 when unused)


class IterStats(NamedTuple):
    mean_reward: torch.Tensor
    ep_return_sum: torch.Tensor   # sum of completed episode returns
    ep_count: torch.Tensor
    ep_len_sum: torch.Tensor
    pg_loss: torch.Tensor
    v_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    clip_frac: torch.Tensor
    log_std_mean: torch.Tensor
    v_loss_max: torch.Tensor
    lr_scale: float
    # max active contacts dropped by slot saturation in the rollout
    contact_overflow_max: torch.Tensor
    # valid rows in the on-policy handoff buffer (None when unused)
    handoff_count: Optional[torch.Tensor] = None


def _f32(x) -> float:
    return float(np.float32(x))


class Adam:
    """Adam with optax.adam's arithmetic, over a list of parameters.

    torch.optim.Adam computes the bias corrections 1 - b^t in float64;
    optax does so in float32 with b rounded to float32, which makes its
    second-moment correction 1.29e-5 smaller at every step count (1 -
    float32(0.999)) and its steps 6.4e-6 shorter. With torch.optim.Adam,
    fused or not, PPO's approximate KL moved 1.3e-5 to 1.6e-5 relative
    against the JAX package, outside the parity tests' 1e-5, so this
    class keeps optax's arithmetic: mu = (1-b1) g + b1 mu, nu = (1-b2)
    g^2 + b2 nu, p -= lr (mu / bc1) / (sqrt(nu / bc2) + eps).

    It costs launches on the update: seven foreach calls per step, six
    device kernels on an H100, where torch.optim.Adam(fused=True) takes
    two (ROADMAP Queue 2 queues a fused kernel with optax's arithmetic).
    """

    def __init__(self, params, eps: float = 1e-5, b1: float = 0.9,
                 b2: float = 0.999):
        self.params = list(params)
        self.eps, self.b1, self.b2 = eps, b1, b2
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float):
        self.count += 1
        bc1 = _f32(1.0 - np.float32(self.b1) ** np.float32(self.count))
        bc2 = _f32(1.0 - np.float32(self.b2) ** np.float32(self.count))
        grads = [p.grad for p in self.params]
        # seven foreach calls, each over all the parameters
        torch._foreach_lerp_(self.mu, grads, 1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, 1.0 - self.b2)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_addcdiv_(self.params, self.mu, den, -lr / bc1)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu)}

    def load_state_dict(self, sd: dict):
        self.count = int(sd["count"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            for d, s in zip(dst, sd[key]):
                d.copy_(s)


def _gather_columns(sharding, xs, dim: int):
    """Each of ``xs`` (tensors of one leading shape, any dtypes)
    gathered along ``dim`` in rank order, through one all_gather of one
    float32 buffer. The values it carries are float32 or small integers
    and masks, which float32 holds exactly."""
    lead = xs[0].shape[:dim + 1]
    cols = [x.reshape(lead + (-1,)) for x in xs]
    flat = sharding.gather(torch.cat([c.to(torch.float32) for c in cols],
                                     -1), dim)
    out = flat.split([c.shape[-1] for c in cols], -1)
    return tuple(o.reshape(o.shape[:dim + 1] + x.shape[dim + 1:]).to(x.dtype)
                 for o, x in zip(out, xs))


class PPO:
    """Trainer bound to a functional env (``DPEnv`` or
    ``DPCombinedEnv``)."""

    def __init__(self, env, cfg: Optional[PPOConfig] = None):
        self.env = env
        self.cfg = cfg or PPOConfig()
        env_cfg = getattr(env, "ENV_CFG", None)
        self._handoff = bool(
            hasattr(env, "make_handoff_buffer") and env_cfg is not None
            and getattr(env_cfg, "HANDOFF_BUFFER_FRAC", 0.0) > 0.0)
        self.device = env.device
        cfg = self.cfg
        self.steps_per_iter = cfg.horizon * cfg.n_envs
        self.n_minibatches = max(self.steps_per_iter // cfg.minibatch_size, 1)
        n_iters = max(cfg.total_timesteps // self.steps_per_iter, 1)
        self.schedule_steps = n_iters * cfg.epochs * self.n_minibatches

    # ---- initialization -------------------------------------------------
    def make_net(self, generator: Optional[torch.Generator] = None):
        """The policy, initialized on the CPU from ``generator`` (so the
        card and the CPU start from the same weights), on the env's
        device."""
        cfg = self.cfg
        return networks.make_policy(
            cfg.policy, self.env, net_arch=cfg.net_arch,
            init_log_std=cfg.init_log_std, log_std_min=cfg.log_std_min,
            log_std_max=cfg.log_std_max, device="cpu",
            generator=generator).to(self.device)

    def init(self, seed: int = 0) -> TrainState:
        cfg = self.cfg
        net = self.make_net(torch.Generator().manual_seed(seed))
        gens = {name: torch.Generator(device=self.device).manual_seed(
            seed * 4 + i + 1) for i, name in enumerate(("act", "perm",
                                                         "rsi"))}
        with torch.no_grad():
            env_states, obs = self.env.reset(cfg.n_envs,
                                             generator=gens["rsi"])
        return TrainState(
            net=net, opt=Adam(net.parameters(), eps=cfg.adam_eps),
            env_states=env_states, last_obs=obs, gens=gens, global_step=0,
            ep_return=torch.zeros(cfg.n_envs, device=self.device),
            ep_length=torch.zeros(cfg.n_envs, dtype=torch.int64,
                                  device=self.device),
            lr_scale=1.0,
            handoff_buf=(self.env.make_handoff_buffer(
                cfg.handoff_buffer_cap) if self._handoff else None))

    # ---- the draws --------------------------------------------------------
    def draw_noise(self, ts: TrainState, mean: torch.Tensor) -> torch.Tensor:
        """The action noise of the global batch: ``mean`` holds this
        rank's rows, the draw has W times as many."""
        world = ts.mesh.world if ts.mesh is not None else 1
        return torch.randn((mean.shape[0] * world,) + mean.shape[1:],
                           generator=ts.gens["act"], dtype=mean.dtype,
                           device=mean.device)

    def draw_perm(self, ts: TrainState, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=ts.gens["perm"],
                              device=self.device)

    # ---- data parallelism -----------------------------------------------
    @staticmethod
    def _sharding(ts: TrainState):
        return None if ts.mesh is None else data_sharding(ts.mesh)

    def _check_mesh(self, ts: TrainState):
        """A sharded state must split the config's batch and minibatches
        evenly over its ranks."""
        if ts.mesh is None:
            return
        cfg, world = self.cfg, ts.mesh.world
        if cfg.minibatch_size % world:
            raise ValueError(f"minibatch_size {cfg.minibatch_size} does not "
                             f"split over {world} ranks")
        if ts.last_obs.shape[0] * world != cfg.n_envs:
            raise ValueError(
                f"{ts.last_obs.shape[0]} envs on each of {world} ranks, "
                f"n_envs {cfg.n_envs}: place the state with "
                "parallel.shard_train_state")

    # ---- one iteration ----------------------------------------------------
    def rollout(self, ts: TrainState):
        """``horizon`` steps of step_auto_reset under the sampled policy.
        Returns (Transition of (horizon, n_envs, ...) tensors, per-step
        stats) and advances ``ts``'s env fields."""
        cfg = self.cfg
        net = ts.net
        states, obs = ts.env_states, ts.last_obs
        ep_ret, ep_len = ts.ep_return, ts.ep_length
        hbuf = ts.handoff_buf
        sh = self._sharding(ts)
        env_kw = {} if sh is None else {"shard": sh}
        trs, stats = [], []
        with torch.no_grad():
            for _ in range(cfg.horizon):
                mean, log_std, value = net(obs)
                noise = self.draw_noise(ts, mean)
                if sh is not None:
                    noise = sh.shard(noise)
                action = mean + torch.exp(log_std) * noise
                logp = networks.gaussian_logp(action, mean, log_std)
                env_a = networks.env_action(net, obs, action)
                if self._handoff:
                    prev_motion = states.motion_id
                    prev_pa = states.player_action
                    states, out = self.env.step_auto_reset(
                        states, env_a, ts.gens["rsi"], handoff_buf=hbuf,
                        **env_kw)
                    rows = (self.env.handoff_capture_mask(prev_motion, out),
                            states.qpos, states.qvel, prev_pa, out.motion_id)
                    if sh is not None:
                        rows = _gather_columns(sh, rows, 0)
                    hbuf = self.env.update_handoff_buffer(hbuf, *rows)
                else:
                    states, out = self.env.step_auto_reset(
                        states, env_a, ts.gens["rsi"], **env_kw)
                ep_ret = ep_ret + out.reward
                ep_len = ep_len + 1
                done_f = out.done.to(torch.float32)
                ov = getattr(out, "contact_overflow", None)
                ov_max = (ov.max() if ov is not None
                          else torch.zeros((), dtype=torch.int64,
                                           device=self.device))
                stats.append(torch.stack([
                    out.reward.mean(), (ep_ret * done_f).sum(), done_f.sum(),
                    (ep_len * out.done).sum().to(torch.float32),
                    ov_max.to(torch.float32)]))
                ep_ret = torch.where(out.done, 0.0, ep_ret)
                ep_len = torch.where(out.done, 0, ep_len)
                shaping = (cfg.vel_shaping * out.vel_match if cfg.vel_shaping
                           else torch.zeros_like(out.reward))
                trs.append(Transition(obs, action, logp, value, out.reward,
                                      out.done, shaping))
                obs = out.obs   # the terminal obs on an auto-reset step
        traj = Transition(*[torch.stack(x) for x in zip(*trs)])
        ts.env_states, ts.last_obs = states, obs
        ts.ep_return, ts.ep_length = ep_ret, ep_len
        ts.handoff_buf = hbuf
        stats = torch.stack(stats)
        if sh is not None:
            # per step: the means of equal slices and the sums are summed
            # (the means then divided by W), the overflow maxed
            mesh = ts.mesh
            sums = mesh.all_reduce(stats[:, :4])
            sums[:, 0] /= mesh.world
            ov = mesh.all_reduce(stats[:, 4:], op=dist.ReduceOp.MAX)
            stats = torch.cat([sums, ov], 1)
        return traj, stats

    def gae(self, ts: TrainState, traj: Transition):
        """(advantages, returns), each (horizon, n_envs). The bootstrap
        value is the net's at ``ts.last_obs`` (after the rollout)."""
        cfg = self.cfg
        with torch.no_grad():
            last_value = ts.net(ts.last_obs)[2]
        shaped = cfg.alive_bonus or cfg.vel_shaping
        frac = 1.0
        if shaped and cfg.alive_bonus_decay_steps:
            frac = float(np.clip(
                1.0 - (np.float32(ts.global_step)
                       / np.float32(cfg.alive_bonus_decay_steps)),
                0.0, 1.0).astype(np.float32))
        adv = torch.zeros_like(last_value)
        value_next = last_value
        advs = []
        for t in reversed(range(cfg.horizon)):
            nonterminal = 1.0 - traj.done[t].to(torch.float32)
            r = traj.reward[t]
            if shaped:
                # both shaping terms gated by nonterminal: no training
                # signal on the step whose bootstrap is cut
                r = r + frac * (cfg.alive_bonus + traj.shaping[t]) \
                    * nonterminal
            delta = r + cfg.gamma * value_next * nonterminal - traj.value[t]
            adv = delta + cfg.gamma * cfg.gae_lambda * nonterminal * adv
            advs.append(adv)
            value_next = traj.value[t]
        advantages = torch.stack(advs[::-1])
        return advantages, advantages + traj.value

    def loss(self, net, mb, adv_all=None):
        """(total, (pg_loss, v_loss, entropy, approx_kl, clip_frac)) of
        one minibatch (obs, action, old_logp, old_value, adv, ret). The
        advantages are normalized by the mean and std of ``adv_all``:
        the whole minibatch's, of which ``mb`` is a rank's part (default:
        ``mb``'s own)."""
        cfg = self.cfg
        obs, action, old_logp, old_value, adv, ret = mb
        if adv_all is None:
            adv_all = adv
        mean, log_std, value = net(obs)
        logp = networks.gaussian_logp(action, mean, log_std)
        ratio = torch.exp(logp - old_logp)
        adv_n = (adv - adv_all.mean()) / torch.clamp(
            adv_all.std(unbiased=False), min=cfg.adv_std_floor)
        pg1 = -adv_n * ratio
        pg2 = -adv_n * torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
        pg_loss = torch.maximum(pg1, pg2).mean()
        if cfg.clip_vf is not None:
            v_clipped = old_value + torch.clamp(value - old_value,
                                                -cfg.clip_vf, cfg.clip_vf)
            v_loss = 0.5 * torch.maximum((value - ret) ** 2,
                                         (v_clipped - ret) ** 2).mean()
        else:
            v_loss = 0.5 * ((value - ret) ** 2).mean()
        ent = networks.gaussian_entropy(log_std).mean()
        total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        kl = ((ratio - 1) - torch.log(ratio)).mean()
        clipfrac = (torch.abs(ratio - 1) > cfg.clip_eps).to(
            torch.float32).mean()
        return total, torch.stack([pg_loss, v_loss, ent, kl, clipfrac])

    def lr_at(self, n_updates: int, lr_scale: float) -> float:
        """optax.linear_schedule(lr, lr*lr_final_frac, schedule_steps) at
        ``n_updates``, times the adaptive scale when that is on."""
        cfg = self.cfg
        lr = cfg.lr
        if cfg.lr_final_frac != 1.0:
            end = cfg.lr * cfg.lr_final_frac
            frac = 1.0 - _f32(min(max(n_updates, 0), self.schedule_steps)
                              / self.schedule_steps)
            lr = (cfg.lr - end) * frac + end
        return lr * lr_scale if cfg.adaptive_lr_kl else lr

    def _clip_grads(self, params):
        """optax.clip_by_global_norm: g * max_norm / |g| when |g| >=
        max_norm, else g (no epsilon)."""
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        keep = norm < self.cfg.max_grad_norm
        # g / 1 * 1 when kept, else g / norm * max_norm
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(
            keep, 1.0, torch.full_like(norm, self.cfg.max_grad_norm)))

    def minibatch_step(self, ts: TrainState, mb, params, adv_all=None):
        """One clipped update of ``ts``'s params (``params``, in order)
        on minibatch ``mb`` (a rank's part of the minibatch whose
        advantages are ``adv_all``, when sharded); returns its five
        losses. Sharded, the gradients are averaged over the ranks in one
        all_reduce of one flat buffer before the clip."""
        ts.opt.zero_grad()
        total, aux = self.loss(ts.net, mb, adv_all)
        total.backward()
        with torch.no_grad():
            if ts.mesh is not None:
                grads = [p.grad for p in params]
                flat = ts.mesh.all_reduce(
                    torch.cat([g.reshape(-1) for g in grads]))
                flat /= ts.mesh.world
                torch._foreach_copy_(grads, [
                    v.view_as(g) for v, g in zip(
                        flat.split([g.numel() for g in grads]), grads)])
            self._clip_grads(params)
        ts.opt.step(self.lr_at(ts.opt.count, ts.lr_scale))
        return aux.detach()

    def update(self, ts: TrainState, batch):
        """``epochs`` passes over ``batch`` = (obs, action, logp, value,
        adv, ret), each flattened to (B, ...) (the global batch, on every
        rank, when sharded: each rank then takes its part of every
        minibatch). Returns the (epochs, n_minibatches, 5) losses
        (averaged over the ranks)."""
        cfg = self.cfg
        B = batch[0].shape[0]
        n_mb = self.n_minibatches
        params = list(ts.net.parameters())
        sh = self._sharding(ts)
        aux, stopped = [], False
        for _ in range(cfg.epochs):
            perm = self.draw_perm(ts, B)
            idxs = perm[:n_mb * cfg.minibatch_size].reshape(
                n_mb, cfg.minibatch_size)
            ep_aux = []
            for idx in idxs:
                adv_all = None
                if sh is not None:
                    adv_all, idx = batch[4][idx], sh.shard(idx)
                mb = [x[idx] for x in batch]
                if stopped:
                    with torch.no_grad():
                        ep_aux.append(self.loss(ts.net, mb, adv_all)[1])
                    continue
                ep_aux.append(self.minibatch_step(ts, mb, params, adv_all))
            ep_aux = torch.stack(ep_aux)
            if sh is not None:
                ep_aux = ts.mesh.all_reduce(ep_aux) / ts.mesh.world
            aux.append(ep_aux)
            if cfg.target_kl is not None and not stopped:
                stopped = float(aux[-1][:, 3].mean()) > 1.5 * cfg.target_kl
        return torch.stack(aux)

    def train_iter(self, ts: TrainState):
        """One iteration (rollout + GAE + update); advances ``ts`` in
        place and returns (ts, IterStats)."""
        cfg = self.cfg
        self._check_mesh(ts)
        traj, stats = self.rollout(ts)
        adv, ret = self.gae(ts, traj)
        B = self.steps_per_iter
        parts = (traj.obs, traj.action, traj.logp, traj.value, adv, ret)
        if ts.mesh is not None:
            # the global (horizon, n_envs, ...) trajectory, in env order
            parts = _gather_columns(self._sharding(ts), parts, 1)
        batch = [x.reshape((B,) + x.shape[2:]) for x in parts]
        aux = self.update(ts, batch)
        means = aux.reshape(-1, 5).mean(0)
        if cfg.adaptive_lr_kl and cfg.target_kl is not None:
            kl_e0 = float(aux[0, :, 3].mean())   # epoch 1: always unmasked
            s = np.float32(ts.lr_scale)
            if kl_e0 > 1.5 * cfg.target_kl:
                s = s * np.float32(0.7)
            elif kl_e0 < 0.5 * cfg.target_kl:
                s = s * np.float32(1.05)
            ts.lr_scale = float(np.clip(s, np.float32(cfg.lr_min_scale),
                                        np.float32(1.0)))
        ts.global_step += B
        it = IterStats(
            mean_reward=stats[:, 0].mean(), ep_return_sum=stats[:, 1].sum(),
            ep_count=stats[:, 2].sum(), ep_len_sum=stats[:, 3].sum(),
            pg_loss=means[0], v_loss=means[1], entropy=means[2],
            approx_kl=means[3], clip_frac=means[4],
            log_std_mean=ts.net.log_std.detach().mean(),
            v_loss_max=aux[..., 1].max(), lr_scale=ts.lr_scale,
            contact_overflow_max=stats[:, 4].max(),
            handoff_count=(ts.handoff_buf.count if self._handoff
                           else None))
        return ts, it

    # ---- host loop -------------------------------------------------------
    def train(self, total_timesteps: Optional[int] = None, seed: int = 0,
              callback=None, log_every: int = 1, verbose: bool = True,
              init_params=None):
        """``init_params``: a state dict to warm-start the policy/value
        params from (fresh optimizer and env state)."""
        cfg = self.cfg
        total = total_timesteps or cfg.total_timesteps
        ts = self.init(seed)
        if init_params is not None:
            ts.net.load_state_dict(init_params)
        n_iters = max(total // self.steps_per_iter, 1)
        t0 = time.time()
        for it in range(n_iters):
            ts, stats = self.train_iter(ts)
            if callback is not None:
                callback(it, ts, stats)
            if verbose and (it % log_every == 0):
                sps = (it + 1) * self.steps_per_iter / (time.time() - t0)
                n_ep = max(float(stats.ep_count), 1.0)
                step = (it + 1) * self.steps_per_iter
                print(f"iter {it:5d} step {step:>12,} sps {sps:>11,.0f} "
                      f"r/step {float(stats.mean_reward):.3f} ep_rew "
                      f"{float(stats.ep_return_sum) / n_ep:8.2f} ep_len "
                      f"{float(stats.ep_len_sum) / n_ep:7.1f} "
                      f"kl {float(stats.approx_kl):.4f}", flush=True)
        return ts

    # ---- inference --------------------------------------------------------
    def act(self, net, obs, deterministic: bool = True,
            generator: Optional[torch.Generator] = None):
        """(env-space action, value); PD policies transform here."""
        with torch.no_grad():
            mean, log_std, value = net(obs)
            if deterministic:
                return networks.env_action(net, obs, mean), value
            a, _ = networks.sample_action(mean, log_std, generator)
            return networks.env_action(net, obs, a), value
