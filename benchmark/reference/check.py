"""The comparisons that decide ``correct``.

Every comparison takes what the program produced at the timed sizes and
works it out again in float64 from the program's own inputs of that
stage: the env step from the program's pre-step state and action, the
policy from the observation the program fed it and the noise it drew,
GAE from the program's trajectory, and the update's first three Adam
steps from the seed's initial weights and the program's batch. The
control is the same reference in float32 with TF32 matmuls, put in the
program's place: ``candidate="tf32"`` reads the control's numbers.

Numbers (each compared with its limit in ``limits/<cell>.json``):

- ``step_gap_p99``: per env row of the sampled steps, the largest of the
  sampled action's gap (as in ``policy_gap``), the observation's gap
  (scaled by max(1, the row's largest |obs|)), the reward's gap, the
  velocity's gap after the step (scaled by max(1, the row's largest
  velocity change)), and 1 for a done flag or a discrete state field
  (clip frame, motion, episode length) that differs; the 99th
  percentile over the rows: a step is one policy sample and one env
  step.
- ``reset_mismatch``: rows the program reset whose new state is not a
  fresh state: the clip's frame (or, in the combined env, its facedown
  variant or a row of the handoff buffer), episode counters zero, the
  empty warm start. Exact.
- ``policy_gap``: the largest gap of the sampled action (scaled by
  max(1, the largest |action|)), and in the PPO cells of the
  log-probability and the value (scaled by max(1, |reference|)), over
  every row compared.
- ``gae_gap``: the largest gap of the advantages and returns over
  max(1, the largest |return|).
- ``loss_gap``: the largest relative gap of the total loss over the
  update's first three Adam steps.
- ``grad_gap`` / ``update_gap``: over the parameter leaves, the largest
  gap between the norms of the first gradient (as Adam gets it, after
  the clip) / of the change after three steps, over the larger of the
  reference leaf's norm and the median leaf's. Leaves whose reference
  gradient is under a thousandth of the median leaf's are left out.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from reference import policy, ppo
from reference.utils.device import DT

@contextlib.contextmanager
def precision(name: str):
    """Reference arithmetic: float64, or float32 with TF32 matmuls."""
    old = DT.F, torch.backends.cuda.matmul.allow_tf32
    DT.F = torch.float64 if name == "float64" else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    try:
        yield DT.F
    finally:
        DT.F, torch.backends.cuda.matmul.allow_tf32 = old


def _cast(x, dtype):
    return x.to(dtype) if x.is_floating_point() else x


class Reference:
    """The reference env of a cell, built once per precision."""

    def __init__(self, env_spec: dict, device):
        self.spec = env_spec
        self.device = torch.device(device)
        self._envs = {}

    def env(self, name: str):
        if name not in self._envs:
            from reference.envs import (
                DPCombinedEnv, DPCombinedEnvConfig, DPEnv,
            )
            s = self.spec
            with precision(name):
                if s["env"] == "dp_env":
                    e = DPEnv(motion=s["motion"], robot=s["robot"],
                              max_contacts=s["max_contacts"],
                              device=self.device)
                else:
                    e = DPCombinedEnv(cfg=DPCombinedEnvConfig(
                        HANDOFF_BUFFER_FRAC=s["handoff_buffer"],
                        FACEDOWN_RSI_FRAC=s["facedown_rsi"]),
                        max_contacts=s["max_contacts"], device=self.device)
            self._envs[name] = e
        return self._envs[name]

    def step(self, name: str, pre, action):
        """(new state, out) of one env step in precision ``name``."""
        from reference.envs.combined_env import CombinedEnvState
        from reference.envs.dp_env import DPEnvState

        env = self.env(name)
        cls = DPEnvState if self.spec["env"] == "dp_env" else CombinedEnvState
        with precision(name) as dt:
            st = cls(*[_cast(x.to(self.device), dt) for x in pre])
            with torch.no_grad():
                return env.step(st, _cast(action.to(self.device), dt))


def _discrete(state):
    """Integer fields of an env state, stacked (B, k)."""
    return torch.stack([x for x in state if not x.is_floating_point()], 1)


def _rowmax(x):
    return x.abs().reshape(x.shape[0], -1).amax(1)


def step_rows(ref: Reference, cap: dict, candidate: str = "program"):
    """Per-row gap of one captured env step (numpy, (B,))."""
    new_r, out_r = ref.step("float64", cap["pre"], cap["action"])
    if candidate == "program":
        obs, rew, done = cap["obs"], cap["reward"], cap["done"]
        new = cap["post"]
    else:
        new, out = ref.step(candidate, cap["pre"], cap["action"])
        obs, rew, done = out.obs, out.reward, out.done
    dev, f64 = ref.device, torch.float64
    obs, rew, done = obs.to(dev, f64), rew.to(dev, f64), done.to(dev)
    qvel_pre = cap["pre"][1].to(dev, f64)
    obs_gap = _rowmax(obs - out_r.obs) / torch.clamp(_rowmax(out_r.obs),
                                                      min=1.0)
    rew_gap = (rew - out_r.reward).abs()
    both = ~done & ~out_r.done
    dq = new.qvel.to(dev, f64) - new_r.qvel
    acc_gap = torch.where(both, _rowmax(dq) / torch.clamp(
        _rowmax(new_r.qvel - qvel_pre), min=1.0), 0.0)
    disc = (_discrete(new).to(dev) != _discrete(new_r)).any(1) & both
    flips = (done != out_r.done) | disc
    gap = torch.maximum(torch.maximum(obs_gap, rew_gap), acc_gap)
    gap = torch.where(flips, torch.clamp(gap, min=1.0), gap)
    return gap.cpu().numpy()


def reset_rows(ref: Reference, cap: dict) -> int:
    """Rows the program reset (its done flag) whose new state is not a
    fresh state. Exact: the program's clip tables are the float32
    rounding of the reference's."""
    env = ref.env("float64")
    dev = ref.device
    post = [x.to(dev) for x in cap["post"]]
    done = cap["done"].to(dev)
    f32 = lambda x: x.to(torch.float32)
    if ref.spec["env"] == "dp_env":
        qpos, qvel, idx, ep_len, ep_rew, lam = post
        ok = ((qpos == f32(env.mocap_qpos[idx])).all(1)
              & (qvel == f32(env.mocap_qvel[idx])).all(1))
    else:
        from reference.envs.combined_env import GETUP, PA_WALK
        qpos, qvel, motion, n_steps, pa, ep_len, ep_rew, lam = post
        q, v, _, _ = env._mocap_at(motion, n_steps
                                   % env.motion_lengths[motion])
        still = (qvel == 0).all(1) & (n_steps == 0) & (motion == GETUP)
        ok = ((qpos == f32(q)).all(1) & ((qvel == f32(v)).all(1) | still)
              & (pa == PA_WALK))
        buf = cap.get("handoff")
        if buf is not None:
            bq, bv, bpa, bmot, _, count = [x.to(dev) for x in buf]
            valid = torch.arange(bq.shape[0], device=dev) < count
            hit = (((qpos[:, None] == bq[None]).all(2))
                   & ((qvel[:, None] == bv[None]).all(2))
                   & (motion[:, None] == bmot[None])
                   & (pa[:, None] == bpa[None]) & valid[None]).any(1)
            ok = ok | (hit & (n_steps == 1))
    empty = f32(env.engine.empty_lam(qpos.shape[0], torch.float64))
    ok = ok & (ep_len == 0) & (ep_rew == 0) & (lam == empty).all(1)
    return int((done & ~ok).sum())


def policy_rows(params64: dict, hp: dict, obs, noise, action, logp=None,
                value=None, candidate: str = "program"):
    """Per-row policy gap (numpy, (N,)): the sampled action from (obs,
    noise), scaled by max(1, the largest |action|), and with ``logp`` /
    ``value`` their gaps over max(1, |reference|)."""
    dev = noise.device
    lo, hi = hp["log_std_min"], hp["log_std_max"]

    def run(dt):
        p = {k: v.to(dev, dt) for k, v in params64.items()}
        mean, log_std, v = policy.forward(p, obs.to(dt), lo, hi)
        a = mean + torch.exp(log_std) * noise.to(dt)
        return a, policy.gaussian_logp(a, mean, log_std), v

    with precision("float64"):
        a_r, lp_r, v_r = run(torch.float64)
    if candidate == "program":
        a_c, lp_c, v_c = action, logp, value
    else:
        with precision(candidate):
            a_c, lp_c, v_c = run(torch.float32)
    f = lambda x: x.to(torch.float64)
    gap = _rowmax(f(a_c) - a_r) / max(1.0, float(a_r.abs().max()))
    if lp_c is not None:
        gap = torch.maximum(gap, (f(lp_c) - lp_r).abs()
                            / lp_r.abs().clamp(min=1.0))
        gap = torch.maximum(gap, (f(v_c) - v_r).abs()
                            / v_r.abs().clamp(min=1.0))
    return gap.cpu().numpy()


def gae_gap(params64, hp, traj, last_obs, adv, ret,
            candidate: str = "program"):
    """Largest gap of the advantages and returns."""
    f = lambda x: x.to(torch.float64)

    def run(dt):
        p = {k: v.to(last_obs.device, dt) for k, v in params64.items()}
        last_v = policy.forward(p, last_obs.to(dt), hp["log_std_min"],
                                hp["log_std_max"])[2]
        return ppo.gae(traj["reward"].to(dt), traj["done"],
                       traj["value"].to(dt), last_v, hp["gamma"],
                       hp["gae_lambda"])

    with precision("float64"):
        adv_r, ret_r = run(torch.float64)
    if candidate != "program":
        with precision(candidate):
            adv, ret = run(torch.float32)
    gap = max(float((f(adv) - adv_r).abs().max()),
              float((f(ret) - ret_r).abs().max()))
    return gap / max(1.0, float(ret_r.abs().max()))


def _leaf_gaps(cand: dict, ref: dict, grad_ref: dict) -> float:
    norm = lambda d: {k: float(torch.linalg.vector_norm(v.double()))
                      for k, v in d.items()}
    nc, nr, ng = norm(cand), norm(ref), norm(grad_ref)
    med_g = float(np.median(list(ng.values())))
    keep = [k for k in nr if ng[k] >= 1e-3 * med_g]
    med = float(np.median([nr[k] for k in keep]))
    return max(abs(nc[k] - nr[k]) / max(nr[k], med) for k in keep)


def update_gaps(params64: dict, hp: dict, minibatches, cand: dict,
                candidate: str = "program", part=None):
    """(loss_gap, grad_gap, update_gap) of the first Adam steps.
    ``cand`` (the program's): ``losses``, ``grad`` (the first gradient
    as Adam gets it) and ``params`` (after the steps), from ``p0``;
    with ``part``, its losses are those of rank 0's share."""
    dev = minibatches[0][0].device
    with precision("float64"):
        mbs = [[x.to(torch.float64) if x.is_floating_point() else x
                for x in mb] for mb in minibatches]
        p64 = {k: v.to(dev, torch.float64) for k, v in params64.items()}
        losses_r, g_r, p_r = ppo.update_steps(p64, mbs, hp, part)
    if candidate != "program":
        with precision(candidate):
            mbs = [[x.to(torch.float32) if x.is_floating_point() else x
                    for x in mb] for mb in minibatches]
            p32 = {k: v.to(dev, torch.float32) for k, v in params64.items()}
            losses, g, p_after = ppo.update_steps(p32, mbs, hp, part)
            cand = dict(losses=losses, grad=g, params=p_after, p0=p32)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(cand["losses"], losses_r))
    grad_gap = _leaf_gaps(cand["grad"], g_r, g_r)
    d_c = {k: cand["params"][k].double() - cand["p0"][k].double()
           for k in p_r}
    d_r = {k: p_r[k] - p64[k] for k in p_r}
    return loss_gap, grad_gap, _leaf_gaps(d_c, d_r, g_r)

