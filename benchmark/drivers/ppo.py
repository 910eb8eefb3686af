"""PPO training: the training CLI's job (``rl/train.py:build`` from the
traffic file's ``argv``), looped ``PPO.train_iter`` by whole iterations.

Set-up builds the env and the train state from the seed and runs
``warmup_iters`` iterations through ``train_iter``; the first is the one
the check follows (its rollout's env steps drawn from the seed, its
policy samples, its GAE, and the first three Adam steps of its update).
The window then loops ``train_iter`` until ``--seconds`` have passed and
finishes the iteration in flight. End-to-end: ``train_memory_peak_gb``,
the card memory the job held at its peak (the allocator's, from set-up
through the window). The rate, all env steps of the window's iterations
over their wall time (synchronised at both ends), goes to the info line
and to a per-layer reader. ``--trace 1`` times ``PPO.rollout`` and
``PPO.update`` in the window (each span ends in a synchronize) and
profiles one iteration after it."""
import contextlib
import time

from bmk import capture, card, trace

FAULTS = ("skipped_update", "half_batch", "altered_reward")


def build(ctx):
    """(ppo, train state) of the traffic's CLI argv, at the tests' sizes
    where given; the PPOConfig must hold the traffic file's values."""
    from deepmimic_mujoco_tpu_torch.rl.ppo import PPO
    from deepmimic_mujoco_tpu_torch.rl.train import build as cli_build
    from deepmimic_mujoco_tpu_torch.rl.train import parse_reason

    tr = ctx.traffic
    hp = dict(tr["ppo"], **{k: v for k, v in ctx.sizes.items()
                            if k in tr["ppo"]})
    argv = ["benchmark", "--no-wandb", "--no-render", "--device",
            ctx.device, "--seed", str(ctx.seed), *tr["argv"],
            "--handoff-buffer", str(tr["env"]["handoff_buffer"]),
            "--facedown-rsi", str(tr["env"]["facedown_rsi"]),
            "--n-envs", str(hp["n_envs"]), "--horizon", str(hp["horizon"]),
            "--minibatch", str(hp["minibatch_size"]),
            "--epochs", str(hp["epochs"])]
    env, cfg = cli_build(parse_reason(argv))
    for k, v in hp.items():
        got = getattr(cfg, k)
        if (list(got) if isinstance(got, tuple) else got) != v:
            raise SystemExit(f"PPOConfig.{k} is {got}, the traffic says {v}")
    ctx.check_model(env.engine)
    ctx.hp = hp
    ppo = PPO(env, cfg)
    return ppo, ppo.init(ctx.seed)


class Hooks:
    """Instance-level wrappers on one iteration's calls, keeping copies
    of what it produced for the check."""

    def __init__(self, ppo, ts, picks, n_update_steps: int):
        self.ppo, self.env = ppo, ppo.env
        self.picks, self.n_upd = picks, n_update_steps
        self.cap = dict(steps=[], noise=[], update=[])
        self.k_env = 0
        self.k_upd = 0
        self.cap["p0"] = {k: capture.clone(v) for k, v in
                          ts.net.named_parameters()}
        self._orig = {}
        for name in ("draw_noise", "draw_perm", "gae", "update",
                     "minibatch_step", "rollout"):
            self._orig[name] = getattr(ppo, name)
            setattr(ppo, name, getattr(self, name))
        self._orig_env = self.env.step_auto_reset
        self.env.step_auto_reset = self.step_auto_reset

    def remove(self):
        for name in self._orig:
            delattr(self.ppo, name)
        del self.env.step_auto_reset

    def step_auto_reset(self, states, action, gen, handoff_buf=None, **kw):
        k = self.k_env
        self.k_env += 1
        pre = capture.clone(states) if k in self.picks else None
        buf = capture.clone(handoff_buf) if pre is not None else None
        kw = dict(kw, handoff_buf=handoff_buf) if handoff_buf is not None \
            else kw
        new, out = self._orig_env(states, action, gen, **kw)
        if pre is not None:
            self.cap["steps"].append(dict(
                t=k, pre=pre, handoff=buf, action=capture.clone(action),
                obs=capture.clone(out.obs), reward=capture.clone(out.reward),
                done=capture.clone(out.done), post=capture.clone(new)))
        return new, out

    def draw_noise(self, ts, mean):
        noise = self._orig["draw_noise"](ts, mean)
        self.cap["noise"].append(capture.clone(noise))
        return noise

    def draw_perm(self, ts, n):
        perm = self._orig["draw_perm"](ts, n)
        self.cap.setdefault("perm", capture.clone(perm))
        return perm

    def rollout(self, ts):
        traj, stats = self._orig["rollout"](ts)
        self.cap["traj"] = {k: capture.clone(getattr(traj, k)) for k in (
            "obs", "action", "logp", "value", "reward", "done")}
        self.cap["last_obs"] = capture.clone(ts.last_obs)
        return traj, stats

    def gae(self, ts, traj):
        adv, ret = self._orig["gae"](ts, traj)
        self.cap["adv"], self.cap["ret"] = capture.clone((adv, ret))
        return adv, ret

    def update(self, ts, batch):
        self.cap["batch"] = [capture.clone(x) for x in batch]
        return self._orig["update"](ts, batch)

    def minibatch_step(self, ts, mb, params, adv_all=None):
        aux = self._orig["minibatch_step"](ts, mb, params, adv_all)
        self.k_upd += 1
        if self.k_upd <= self.n_upd:
            entry = dict(aux=capture.clone(aux))
            if self.k_upd == 1:
                entry["mu"] = [capture.clone(m) for m in ts.opt.mu]
            if self.k_upd == self.n_upd:
                entry["params"] = {k: capture.clone(v) for k, v in
                                   ts.net.named_parameters()}
            self.cap["update"].append(entry)
        return aux


def run(ctx, mesh=None):
    """One run; with ``mesh`` (a rank of ``drivers/ppo_dp.py``), the
    train state is placed on it and rank 0 times, traces and checks."""
    import torch

    from deepmimic_mujoco_tpu_torch.ops.fused_solve import fused_solve

    dev = torch.device(ctx.device)
    ppo, ts = build(ctx)
    lead = mesh is None or mesh.rank == 0
    tr = ctx.traffic
    picks = capture.sample_steps(ctx.seed, ctx.hp["horizon"],
                                 ctx.size("check_steps"))
    hooks = Hooks(ppo, ts, picks, tr["check_update_steps"])
    if mesh is not None:
        from deepmimic_mujoco_tpu_torch.parallel.mesh import (
            shard_train_state,
        )
        ts = shard_train_state(ts, mesh)
        if not lead:
            hooks.remove()
    ts, stats = ppo.train_iter(ts)
    if lead:
        hooks.remove()
    overflow = [stats.contact_overflow_max]
    for _ in range(ctx.size("warmup_iters") - 1):
        ts, stats = ppo.train_iter(ts)
    card.sync(dev)
    if mesh is not None:
        mesh.barrier()
    setup_s = time.time() - ctx.t0
    launches0 = dict(fused_solve.launches_by_plan)
    counts0 = dict(mesh.counts) if mesh is not None else None
    if ctx.trace and lead:
        _spans(ctx, ppo, dev)
    iters = 0
    t_start = time.perf_counter()
    marks = [t_start]
    while True:
        ts, stats = ppo.train_iter(ts)
        overflow.append(stats.contact_overflow_max)
        iters += 1
        marks.append(time.perf_counter())
        stop = time.perf_counter() - t_start >= ctx.seconds
        if mesh is not None:     # rank 0's clock decides for every rank
            stop = bool(mesh.broadcast(torch.tensor([float(stop)],
                                                    device=dev)))
        if stop:
            break
    card.sync(dev)
    wall = time.perf_counter() - t_start
    for name in ("rollout", "update"):
        ppo.__dict__.pop(name, None)
    steps = iters * ppo.steps_per_iter
    plans = {k: v - launches0.get(k, 0)
             for k, v in fused_solve.launches_by_plan.items()}
    if mesh is not None:
        counts = {k: (v - counts0[k]) / iters for k, v in mesh.counts.items()}
    world = 1 if mesh is None else mesh.world
    if ctx.trace:
        prof = trace.Profile()
        with trace.profiled(dev, prof) if lead else _nothing():
            ts, stats = ppo.train_iter(ts)
        if lead:
            ctx.profile = prof
            cfg = ppo.cfg
            prof.env_steps = cfg.horizon
            # this rank's share of the global batch's samples
            prof.work = dict(
                policy_samples=cfg.n_envs // world * (cfg.horizon + 1),
                train_samples=cfg.epochs * ppo.n_minibatches
                * (cfg.minibatch_size // world))
            prof.solve_rows = trace.solve_active(prof)
            prof.solves = []
    ctx.info.update(
        card=card.smi() if dev.type == "cuda" else "cpu",
        window_iters=iters, window_s=wall, window_env_steps=steps,
        iter_host_s=[b - a for a, b in zip(marks[:-1], marks[1:])],
        launches_by_plan=plans,
        launches_per_iter=sum(plans.values()) / max(iters, 1),
        contact_overflow_max=int(max(float(o) for o in overflow)),
        handoff_count=None if stats.handoff_count is None
        else int(stats.handoff_count), setup_s=setup_s)
    if mesh is not None:
        ctx.info["mesh_counts_per_iter"] = counts
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    ctx.obs_act = (ppo.env.obs_size, ppo.env.action_size)
    del ppo, ts, stats
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = dict(metrics={"train_memory_peak_gb": memory_peak / 1e9,
                        "setup_s": setup_s},
               attempted=steps, failed=0, memory_peak_bytes=memory_peak)
    if lead:
        ctx.caps = hooks.cap
        out["compared"] = check(ctx, hooks.cap, world=world)
    return out


@contextlib.contextmanager
def _nothing():
    yield


def _spans(ctx, ppo, dev):
    """Time ``PPO.rollout`` and ``PPO.update`` (each span synchronised
    at both ends) in the window of a traced run."""
    for name in ("rollout", "update"):
        fn = getattr(ppo, name)

        def timed(*a, _fn=fn, _name=name, **k):
            card.sync(dev)
            t = time.perf_counter()
            out = _fn(*a, **k)
            card.sync(dev)
            ctx.span(f"ppo_{_name}_s", time.perf_counter() - t)
            return out
        setattr(ppo, name, timed)


def check(ctx, cap, candidate: str = "program", world: int = 1):
    """The compared numbers of the first iteration (``reference.check``);
    ``candidate="tf32"`` reads the control's. Over ``world`` ranks, the
    captures are rank 0's: its envs' steps and samples, and its share of
    each minibatch's loss (the noise and the batch are global)."""
    import numpy as np
    import torch

    from reference import check, policy

    cfg, tr, hp = ctx.config, ctx.traffic, ctx.hp
    ref = check.Reference(dict(
        env="combined", robot=cfg["robot"],
        max_contacts=cfg["max_contacts"], **tr["env"]), ctx.device)
    env = ref.env("float64")
    p0 = policy.init_params(env.obs_size, env.action_size, cfg["net_arch"],
                            hp["init_log_std"], ctx.seed)
    dev = cap["last_obs"].device
    tj = cap["traj"]
    T, N = tj["reward"].shape
    noise = torch.stack(cap["noise"])[:, :N]     # rank 0's envs
    act = check.policy_rows(p0, hp, tj["obs"].reshape(T * N, -1),
                            noise.reshape(T * N, -1),
                            tj["action"].reshape(T * N, -1),
                            tj["logp"].reshape(-1), tj["value"].reshape(-1),
                            candidate=candidate).reshape(T, N)
    pol = float(act.max())
    rows, resets = [], 0
    for s in cap["steps"]:
        rows.append(np.maximum(check.step_rows(ref, s, candidate),
                               act[s["t"]]))
        if candidate == "program":
            resets += check.reset_rows(ref, s)
    rows = np.concatenate(rows)
    gae = check.gae_gap(p0, hp, tj, cap["last_obs"], cap["adv"], cap["ret"],
                        candidate=candidate)
    # the 90th percentile: in the combined env at 24 slots, rows whose
    # contacts overflow and tie in depth keep another subset in float64
    # (the control reads them alike); up to a few % of a seed's rows
    numbers = {"step_gap_p90": float(np.quantile(rows, 0.90)),
               "reset_mismatch": resets, "policy_gap": pol, "gae_gap": gae}
    ctx.info[f"step_gap_quantiles.{candidate}"] = {
        q: float(np.quantile(rows, q)) for q in (0.5, 0.9, 0.99, 0.999, 1.0)}
    n_upd = ctx.traffic["check_update_steps"]
    if candidate == "program" and len(cap["update"]) < n_upd:
        # the update took fewer Adam steps than the check follows: by
        # the measure below, params that did not move read 1
        return dict(numbers, loss_gap=1.0, grad_gap=1.0, update_gap=1.0)
    mbs_n = hp["minibatch_size"]
    idx = cap["perm"][:n_upd * mbs_n].reshape(n_upd, mbs_n)
    minibatches = [[x[i] for x in cap["batch"]] for i in idx]
    upd = cap["update"]
    aux = torch.stack([u["aux"] for u in upd]).double()
    losses = (aux[:, 0] + hp["vf_coef"] * aux[:, 1]
              - hp["ent_coef"] * aux[:, 2]).tolist()
    names = list(cap["p0"])
    prog = dict(losses=losses,
                grad={k: m / (1 - 0.9) for k, m in zip(names, upd[0]["mu"])},
                params=upd[-1]["params"], p0=cap["p0"])
    p0_dev = {k: v.to(dev) for k, v in p0.items()}
    lg, gg, ug = check.update_gaps(
        p0_dev, hp, minibatches, prog, candidate,
        part=mbs_n // world if world > 1 else None)
    return dict(numbers, loss_gap=lg, grad_gap=gg, update_gap=ug)
