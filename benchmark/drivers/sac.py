"""SAC training: the SAC CLI's job (``rl/sac_train.py:build`` from the
traffic's sizes), looped ``SAC.train_iter`` by whole iterations.

Set-up builds the env and the train state from the seed (the replay
buffer on the card: the configuration's ``buffer_size`` rows at the
traffic's sizes, fewer at the tests', ``buffer_rows``) and runs
``warmup_iters`` iterations through ``train_iter``. The first is the one
the check follows: its collect's env steps drawn from the seed, every
sampled action with its log-probability, the buffer rows its first
updates drew, and its first ``check_update_steps`` updates from their
drawn rows and noises. After it, collect-only passes fill the ring
until it wraps (``fill``), so the other iterations run as a deployment
past its first ``buffer_size`` env steps does: every update draws from
the whole buffer and the writes go round the ring. The window then
loops ``train_iter`` until ``--seconds`` have passed and finishes the
iteration in flight. End-to-end: ``train_memory_peak_gb``
(the allocator's peak, from set-up through the window) and ``setup_s``.
The rate, all env steps of the window's iterations over their wall time
(synchronised at both ends), goes to the info line and to a per-layer
reader. ``--trace 1`` times ``SAC.collect`` and ``SAC.update`` in the
window (each span ends in a synchronize) and profiles one iteration
after it: ``horizon`` env steps and the updates, nothing else."""
import time

from bmk import capture, card, trace

FAULTS = ("altered_reward", "frozen_target", "skipped_critic_step",
          "misplaced_rows")
FIELDS = ("obs", "action", "reward", "next_obs", "done")
SCALED = ("n_envs", "horizon", "minibatch_size")


def buffer_rows(config: dict, traffic_sac: dict, hp: dict) -> int:
    """The replay buffer's rows at the run's sizes ``hp``: the
    configuration's ``buffer_size`` at the traffic's own, shrunk in
    proportion to each of the envs, the steps an iteration and the
    minibatch that a run shrinks (the tests' runs: a ring of a few
    iterations, which they fill and wrap in a few collects)."""
    rows = config["buffer_size"]
    for k in SCALED:
        rows = rows * hp[k] // traffic_sac[k]
    return rows


def fill(sac, s) -> int:
    """Collect-only passes (``SAC.collect``, no update) until the ring
    has wrapped; returns how many ran."""
    n = 0
    while not s.buf_full:
        sac.collect(s)
        s.global_step += sac.cfg.n_envs * sac.cfg.steps_per_iter
        n += 1
    return n


def build(ctx):
    """(sac, train state) of the SAC CLI's argv at the traffic's sizes
    (the tests' where given); the SACConfig must hold the traffic's
    values."""
    from deepmimic_mujoco_tpu_torch.rl.sac import SAC
    from deepmimic_mujoco_tpu_torch.rl.sac_train import build as cli_build
    from deepmimic_mujoco_tpu_torch.rl.sac_train import parse_args

    tr, cfg = ctx.traffic, ctx.config
    hp = dict(tr["sac"], **{k: v for k, v in ctx.sizes.items()
                            if k in tr["sac"]})
    rows = buffer_rows(cfg, tr["sac"], hp)
    argv = ["benchmark", "--robot", cfg["robot"], "--motion", tr["motion"],
            "--device", ctx.device, "--seed", str(ctx.seed),
            "--n-envs", str(hp["n_envs"]), "--buffer", str(rows),
            "--batch", str(hp["minibatch_size"]),
            "--steps-per-iter", str(hp["horizon"]),
            "--updates-per-iter", str(hp["updates_per_iter"]),
            "--lr", str(hp["lr"]), "--alpha-lr", str(hp["alpha_lr"]),
            "--log-alpha-min", str(hp["log_alpha_min"]),
            "--critic-warmup", str(hp["critic_warmup"]),
            "--arch", *[str(w) for w in hp["net_arch"]]]
    env, sac_cfg = cli_build(parse_args(argv))
    want = dict(n_envs=hp["n_envs"], buffer_size=rows,
                batch_size=hp["minibatch_size"], steps_per_iter=hp["horizon"],
                updates_per_iter=hp["updates_per_iter"], lr=hp["lr"],
                gamma=hp["gamma"], tau=hp["tau"],
                net_arch=tuple(hp["net_arch"]), action_scale=1.0,
                alpha_lr=hp["alpha_lr"], log_alpha_min=hp["log_alpha_min"],
                critic_warmup_steps=hp["critic_warmup"], actor_lr=None)
    for k, v in want.items():
        if getattr(sac_cfg, k) != v:
            raise SystemExit(f"SACConfig.{k} is {getattr(sac_cfg, k)}, the "
                             f"traffic says {v}")
    ctx.check_model(env.engine)
    sizes = (env.obs_size, env.action_size)
    if sizes != (cfg["obs_size"], cfg["action_size"]) \
            or list(sac_cfg.net_arch) != cfg["net_arch"]:
        raise SystemExit(f"obs, action {sizes} and net_arch "
                         f"{sac_cfg.net_arch} built, the configuration says "
                         f"{cfg['obs_size']}, {cfg['action_size']} and "
                         f"{cfg['net_arch']}")
    if hp["n_envs"] * hp["horizon"] >= rows:
        raise SystemExit(f"{rows} buffer rows hold no more than an "
                         f"iteration")
    ctx.hp = hp
    sac = SAC(env, sac_cfg)
    return sac, sac.init(ctx.seed)


def _state(s) -> dict:
    """The train state on the host: ``params``, the actor's, the
    critics' and the target critics' parameters keyed as
    ``reference/sac.py`` keys them (the target's under ``target.``) and
    log alpha, and ``adam``, each optimizer's (count, mu, nu) keyed
    alike (``reference/sac.py:State`` takes it)."""
    cpu = lambda v: v.detach().to("cpu", copy=True)
    names = dict(actor=[f"actor.{k}" for k, _ in s.actor.named_parameters()],
                 critic=[f"critic.{k}"
                         for k, _ in s.critic.named_parameters()],
                 alpha=["log_alpha"])
    params = {k: cpu(v) for k, v in zip(
        names["actor"] + names["critic"],
        [*s.actor.parameters(), *s.critic.parameters()])}
    params.update({f"target.{k}": cpu(v)
                   for k, v in s.target_critic.named_parameters()})
    params["log_alpha"] = cpu(s.log_alpha)
    adam = {}
    for g, opt in (("actor", s.opt_actor), ("critic", s.opt_critic),
                   ("alpha", s.opt_alpha)):
        adam[g] = (opt.count, dict(zip(names[g], map(cpu, opt.mu))),
                   dict(zip(names[g], map(cpu, opt.nu))))
    return dict(params=params, adam=adam)


class Hooks:
    """Instance-level wrappers on one iteration's calls, keeping copies
    of what it produced for the check: every collect step's policy
    inputs and outputs and env outputs, the picked steps' states, and
    for each of the first ``n_update_steps`` updates its draws, Q
    targets, losses, the temperature's gradient and the train state
    after it (on the host), the state before the first kept too."""

    def __init__(self, sac, s, picks, n_update_steps: int):
        self.sac, self.env = sac, sac.env
        self.picks, self.n_upd = picks, n_update_steps
        self.cap = dict(steps=[], policy=[], out=[], update=[],
                        state0=_state(s), pos0=s.buf_pos)
        self.k_env = 0
        self.k_upd = 0
        self._noise = None
        self._orig = {}
        for name in ("draw_action_noise", "policy", "draw_idx",
                     "next_action", "draw_next_noise", "draw_pi_noise",
                     "q_target", "update_step"):
            self._orig[name] = getattr(sac, name)
            setattr(sac, name, getattr(self, name))
        self._orig_env = self.env.step_auto_reset
        self.env.step_auto_reset = self.step_auto_reset

    def remove(self):
        for name in self._orig:
            delattr(self.sac, name)
        del self.env.step_auto_reset
        self.sac = self.env = self._orig = self._orig_env = None

    def _updating(self) -> bool:
        return 0 < self.k_upd <= self.n_upd

    def draw_action_noise(self, s, mean):
        self._noise = self._orig["draw_action_noise"](s, mean)
        return self._noise

    def policy(self, s, obs):
        a, logp = self._orig["policy"](s, obs)
        self.cap["policy"].append(dict(
            obs=capture.clone(obs), noise=capture.clone(self._noise),
            action=capture.clone(a), logp=capture.clone(logp)))
        return a, logp

    def step_auto_reset(self, states, action, gen, **kw):
        k = self.k_env
        self.k_env += 1
        pre = capture.clone(states) if k in self.picks else None
        new, out = self._orig_env(states, action, gen, **kw)
        self.cap["out"].append(dict(
            obs=capture.clone(out.obs), reward=capture.clone(out.reward),
            done=capture.clone(out.done)))
        if pre is not None:
            self.cap["steps"].append(dict(
                t=k, pre=pre, action=capture.clone(action),
                obs=capture.clone(out.obs), reward=capture.clone(out.reward),
                done=capture.clone(out.done), post=capture.clone(new)))
        return new, out

    def update_step(self, s, valid, warm):
        self.k_upd += 1
        if not self._updating():
            return self._orig["update_step"](s, valid, warm)
        entry = dict(valid=valid, warm=warm)
        self.cap["update"].append(entry)
        closs, aloss = self._orig["update_step"](s, valid, warm)
        entry.update(losses=(float(closs), float(aloss)),
                     alpha_grad=float(s.log_alpha.grad), state=_state(s))
        return closs, aloss

    def draw_idx(self, s, valid):
        idx = self._orig["draw_idx"](s, valid)
        if self._updating():
            self.cap["update"][-1].update(
                idx=capture.clone(idx),
                rows={k: capture.clone(s.buffer[k][idx]) for k in FIELDS})
        return idx

    def next_action(self, s, b_next):
        a, logp = self._orig["next_action"](s, b_next)
        if self._updating():
            self.cap["update"][-1]["logp_next"] = capture.clone(logp)
        return a, logp

    def draw_next_noise(self, s, mean):
        noise = self._orig["draw_next_noise"](s, mean)
        if self._updating():
            self.cap["update"][-1]["next"] = capture.clone(noise)
        return noise

    def draw_pi_noise(self, s, mean):
        noise = self._orig["draw_pi_noise"](s, mean)
        if self._updating():
            self.cap["update"][-1]["pi"] = capture.clone(noise)
        return noise

    def q_target(self, s, *a):
        qt = self._orig["q_target"](s, *a)
        if self._updating():
            self.cap["update"][-1]["q_target"] = capture.clone(qt)
        return qt


def _spans(ctx, sac, dev):
    """Time ``SAC.collect`` and ``SAC.update`` (each span synchronised
    at both ends) in the window of a traced run."""
    for name in ("collect", "update"):
        fn = getattr(sac, name)

        def timed(*a, _fn=fn, _name=name, **k):
            card.sync(dev)
            t = time.perf_counter()
            out = _fn(*a, **k)
            card.sync(dev)
            ctx.span(f"sac_{_name}_s", time.perf_counter() - t)
            return out
        setattr(sac, name, timed)


def run(ctx):
    import statistics

    import torch

    from deepmimic_mujoco_tpu_torch.ops.fused_solve import fused_solve
    from deepmimic_mujoco_tpu_torch.rl.sac import buffer_bytes

    dev = torch.device(ctx.device)
    sac, s = build(ctx)
    hp, cfg = ctx.hp, sac.cfg
    picks = capture.sample_steps(ctx.seed, hp["horizon"],
                                 ctx.size("check_steps"))
    hooks = Hooks(sac, s, picks, min(ctx.size("check_update_steps"),
                                     cfg.updates_per_iter))
    try:
        s, _ = sac.train_iter(s)
    finally:
        hooks.remove()
    card.sync(dev)
    t = time.perf_counter()
    fill_collects = fill(sac, s)
    card.sync(dev)
    fill_s = time.perf_counter() - t
    for _ in range(ctx.size("warmup_iters") - 1):
        s, _ = sac.train_iter(s)
    card.sync(dev)
    setup_s = time.time() - ctx.t0
    launches0 = dict(fused_solve.launches_by_plan)
    if ctx.trace:
        _spans(ctx, sac, dev)
    iters = 0
    t_start = time.perf_counter()
    marks = [t_start]
    while True:
        s, _ = sac.train_iter(s)
        iters += 1
        marks.append(time.perf_counter())
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    card.sync(dev)
    wall = time.perf_counter() - t_start
    for name in ("collect", "update"):
        sac.__dict__.pop(name, None)
    per_iter = cfg.n_envs * cfg.steps_per_iter
    steps = iters * per_iter
    plans = {k: v - launches0.get(k, 0)
             for k, v in fused_solve.launches_by_plan.items()}
    if ctx.trace:
        prof = ctx.profile = trace.Profile()
        with trace.profiled(dev, prof):
            s, _ = sac.train_iter(s)
        prof.env_steps = cfg.steps_per_iter
        prof.work = dict(actor_samples=per_iter,
                         update_samples=cfg.updates_per_iter * cfg.batch_size)
        prof.solve_rows = trace.solve_active(prof)
        prof.solves = []
    ctx.info.update(
        card=card.smi() if dev.type == "cuda" else "cpu",
        window_iters=iters, window_s=wall, window_env_steps=steps,
        iter_host_s=[b - a for a, b in zip(marks[:-1], marks[1:])],
        launches_by_plan=plans,
        launches_per_iter=sum(plans.values()) / max(iters, 1),
        buffer_rows=cfg.buffer_size, buffer_bytes=buffer_bytes(s.buffer),
        buffer_written=cfg.buffer_size if s.buf_full else s.buf_pos,
        fill_collects=fill_collects, fill_s=fill_s, setup_s=setup_s)
    for name in ("collect", "update"):
        xs = ctx.spans.get(f"sac_{name}_s")
        if xs:
            ctx.info[f"{name}_s_mean"] = statistics.fmean(xs)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    ctx.obs_act = (sac.env.obs_size, sac.env.action_size)
    del sac, s
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.caps = hooks.cap
    return dict(metrics={"train_memory_peak_gb": memory_peak / 1e9,
                         "setup_s": setup_s},
                attempted=steps, failed=0, memory_peak_bytes=memory_peak,
                compared=check(ctx, hooks.cap))


def _transitions(cap) -> dict:
    """The collect's transitions in the order it wrote them from row
    ``pos0``: one row per (step, env), as the buffer's fields."""
    import torch

    cat = lambda xs: torch.cat(list(xs))
    return dict(obs=cat(p["obs"] for p in cap["policy"]),
                action=cat(p["action"] for p in cap["policy"]),
                reward=cat(o["reward"] for o in cap["out"]),
                next_obs=cat(o["obs"] for o in cap["out"]),
                done=cat(o["done"] for o in cap["out"]).to(torch.float32))


def _keyed(params: dict, target: dict, log_alpha) -> dict:
    """The reference's quantities keyed as ``_params`` keys the
    program's: ``params``, the target critics (the critic leaves of
    ``target``) under ``target.``, and log alpha."""
    out = {k: v.detach() for k, v in params.items()}
    out.update({"target." + k[len("critic."):]: v.detach()
                for k, v in target.items() if k.startswith("critic.")})
    out["log_alpha"] = log_alpha.detach()
    return out


def _changes(params: dict, start: dict) -> dict:
    """In float64: each leaf's change from ``start``, but for the target
    critics their lag behind the critics (target minus critic). Their
    change from the start, tau times the critics' over a few updates, is
    no larger than float32's rounding of the target itself; the lag is
    the critics' change, which a missing Polyak step alters by tau."""
    import torch

    f64 = lambda x: x.to(torch.float64)
    out = {}
    for k, v in params.items():
        if k.startswith("target."):
            out[k] = f64(v) - f64(params["critic." + k[len("target."):]])
        else:
            out[k] = f64(v) - f64(start[k])
    return out


def _norm_gaps(cand: dict, ref: dict) -> float:
    """Over the leaves of ``ref``: the gap between the norms of the
    candidate's and the reference's leaf, over the larger of the
    reference leaf's norm and the median leaf's."""
    import numpy as np
    import torch

    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    nc = {k: norm(cand[k]) for k in ref}
    nr = {k: norm(v) for k, v in ref.items()}
    med = float(np.median(list(nr.values())))
    return max(abs(nc[k] - nr[k]) / max(nr[k], med, 1e-30) for k in nr)


def check(ctx, cap, candidate: str = "program"):
    """The compared numbers of the first iteration; ``candidate="tf32"``
    reads the control's (the reference in float32 with TF32 matmuls in
    the program's place, from the same inputs).

    - ``step_gap_p90``, ``reset_mismatch``: ``reference/check.py``'s
      ``dp_env`` rows of the picked steps, each row also counting its
      sampled action's gap; the 90th percentile, since rows whose
      contacts overflow 24 slots and tie in depth keep another subset in
      float64 (1-2% of a seed's rows read 1e-4-0.1, the control alike);
    - ``policy_gap``: over every collect step's rows, the largest gap of
      the sampled action (|a| <= 1) and of its log-probability over
      max(1, |reference|), from the obs fed and the noise drawn; the
      log-probability of rows float32 cannot carry
      (``reference/sac.py:COND``) is left out (their action is compared;
      info ``logp_rows_unconditioned``);
    - ``buffer_mismatch``: rows the first updates drew that differ from
      the transition the collect produced at that row (exact);
    - each of the first ``check_update_steps`` updates is worked out
      from the program's own inputs of that update: its train state
      before it (params, target critics, log alpha, the three Adams'
      counts and moments), the collect's transitions at the rows it
      drew, and the noises it drew. (Following the reference's own
      chain instead, its second update would start from params whose
      first Adam step, lr times the gradient's sign, took another sign
      wherever float32 rounds a gradient entry across zero.) Over the
      updates, the largest of:
      ``q_target_gap``: the Q target's gap over max(1, the largest
      |reference|), on every row; on the rows whose next action's
      log-probability float32 cannot carry (``COND``) the reference's
      target takes the candidate's log-probability, its reward, gamma,
      done and target critics still its own (info ``logp_rows_unconditioned``);
      ``critic_loss_gap``, ``actor_loss_gap``: each loss's relative gap,
      the reference's critics regressing to the candidate's Q target
      (that stage's input); ``alpha_gap``: the
      relative gap of the temperature's gradient (as its Adam got it);
      ``update_gap``: per group (actor, critics, target critics, log
      alpha) the gap of each leaf's change over the update (``_changes``:
      for the target critics, their lag behind the critics) in norm,
      over the larger of the reference's and the group's median
      (``_norm_gaps``).
    """
    import numpy as np
    import torch

    from reference import check
    from reference import sac as rsac

    cfg, tr, hp = ctx.config, ctx.traffic, ctx.hp
    ref = check.Reference(dict(env="dp_env", robot=cfg["robot"],
                               motion=tr["motion"],
                               max_contacts=tr["max_contacts"]), ctx.device)
    env = ref.env("float64")
    p0 = rsac.init_params(env.obs_size, env.action_size, hp["net_arch"],
                          ctx.seed)
    dev = cap["policy"][0]["obs"].device
    f64 = lambda x: x.to(torch.float64)
    name = "float64" if candidate == "program" else candidate

    def sampled(prec, dt, obs, noise):
        with check.precision(prec):
            p = {k: v.to(dev, dt) for k, v in p0.items()}
            mean, log_std = rsac.actor(p, obs.to(dt))
            return (mean, log_std, *rsac.squash_sample(mean, log_std,
                                                       noise.to(dt)))

    act_rows, pol, left_out = [], 0.0, 0
    for pc in cap["policy"]:
        mean, log_std, a_r, lp_r = sampled("float64", torch.float64,
                                           pc["obs"], pc["noise"])
        a_c, lp_c = (pc["action"], pc["logp"]) if candidate == "program" \
            else sampled(name, torch.float32, pc["obs"], pc["noise"])[2:]
        a_gap = (f64(a_c) - a_r).abs().amax(1)
        kept = rsac.conditioned(mean, log_std, a_r)
        lp_gap = torch.where(kept, (f64(lp_c) - lp_r).abs()
                             / lp_r.abs().clamp(min=1.0), 0.0)
        left_out += int((~kept).sum())
        act_rows.append(a_gap.cpu().numpy())
        pol = max(pol, float(torch.maximum(a_gap, lp_gap).max()))
    ctx.info[f"logp_rows_unconditioned.{candidate}"] = dict(
        policy=left_out, of=sum(len(pc["obs"]) for pc in cap["policy"]))
    rows, resets = [], 0
    for st in cap["steps"]:
        rows.append(np.maximum(check.step_rows(ref, st, candidate),
                               act_rows[st["t"]]))
        if candidate == "program":
            resets += check.reset_rows(ref, st)
    rows = np.concatenate(rows)
    ctx.info[f"step_gap_quantiles.{candidate}"] = {
        q: float(np.quantile(rows, q)) for q in (0.5, 0.9, 0.99, 0.999, 1.0)}
    numbers = {"step_gap_p90": float(np.quantile(rows, 0.90)),
               "reset_mismatch": resets, "policy_gap": pol}

    trans = _transitions(cap)
    n_rows = trans["reward"].shape[0]
    upd = cap["update"]
    mismatch = 0
    batches = []
    for u in upd:
        # the collect wrote row pos0 + i for its i-th transition; the
        # first iteration's updates draw below the rows it wrote
        i = u["idx"] - cap["pos0"]
        batches.append([trans[k][i] for k in FIELDS])
        if candidate == "program":
            same = torch.ones_like(i, dtype=torch.bool)
            for k in FIELDS:
                got, want = u["rows"][k], trans[k][i]
                same &= (got == want).reshape(len(i), -1).all(1)
            mismatch += int((~same).sum()) + int(
                ((i < 0) | (i >= n_rows)).sum())
    numbers["buffer_mismatch"] = mismatch

    def stage(prec, dt, pre, u, batch, regress_to=None, logp_fed=None):
        """One update in precision ``prec`` from the state ``pre``, the
        critics regressing to ``regress_to`` where given, the Q target
        taking ``logp_fed`` where ``rsac.q_target`` does."""
        with check.precision(prec):
            on = lambda d: {k: v.to(dev, dt) for k, v in d.items()}
            p = on(pre["params"])
            st = rsac.State(
                {k: v for k, v in p.items() if not k.startswith(
                    ("target.", "log_alpha"))}, p["log_alpha"],
                {"critic." + k[len("target."):]: v for k, v in p.items()
                 if k.startswith("target.")},
                {g: (c, on(mu), on(nu))
                 for g, (c, mu, nu) in pre["adam"].items()})
            o = rsac.update(st, [x.to(dt) for x in batch], u["next"].to(dt),
                            u["pi"].to(dt), hp, u["warm"],
                            None if regress_to is None else regress_to.to(dt),
                            logp_fed)
            return dict(q_target=o["q_target"], kept=o["conditioned"],
                        logp_next=o["next_sample"][3],
                        losses=(o["critic_loss"], o["actor_loss"]),
                        alpha_grad=float(o["alpha_grad"]),
                        params=_keyed(st.params, st.target, st.log_alpha))

    gaps = dict(q=[], closs=[], aloss=[], alpha=[], upd=[])
    pre = cap["state0"]
    for u, batch in zip(upd, batches):
        c = (dict(u, params=u["state"]["params"]) if candidate == "program"
             else stage(name, torch.float32, pre, u, batch))
        r = stage("float64", torch.float64, pre, u, batch, c["q_target"],
                  c["logp_next"])
        gaps["q"].append(float((f64(c["q_target"]) - r["q_target"]).abs(
            ).max()) / max(1.0, float(r["q_target"].abs().max())))
        for key, j in (("closs", 0), ("aloss", 1)):
            gaps[key].append(abs(c["losses"][j] - r["losses"][j])
                             / max(abs(r["losses"][j]), 1e-12))
        gaps["alpha"].append(abs(c["alpha_grad"] - r["alpha_grad"])
                             / max(abs(r["alpha_grad"]), 1e-12))
        start = {k: v.to(dev) for k, v in pre["params"].items()}
        d_r = _changes(r["params"], start)
        d_c = _changes({k: v.to(dev) for k, v in c["params"].items()}, start)
        gaps["upd"].append({g: _norm_gaps(
            {k: v for k, v in d_c.items() if k.startswith(g)},
            {k: v for k, v in d_r.items() if k.startswith(g)})
            for g in ("actor.", "critic.", "target.", "log_alpha")})
        ctx.info[f"logp_rows_unconditioned.{candidate}"].setdefault(
            "q_target", []).append(int((~r["kept"]).sum()))
        pre = u["state"]
    ctx.info[f"update_gaps.{candidate}"] = gaps
    numbers.update(q_target_gap=max(gaps["q"]),
                   critic_loss_gap=max(gaps["closs"]),
                   actor_loss_gap=max(gaps["aloss"]),
                   alpha_gap=max(gaps["alpha"]),
                   update_gap=max(max(g.values()) for g in gaps["upd"]))
    return numbers
