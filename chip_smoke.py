"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds:
  0. card: name and power limit (nvidia-smi), torch's device name
  1. build: nvcc of every kernel source of the main path and of the
     fused solve's phase-clock variant, all started together; ptxas's
     registers and spills (any spill fails the run), and the blocks per
     SM that the occupancy calculator gives at humanoid3d and G1 sizes
  2. kernel vs plain: both fused-solve entries against the plain torch
     version on random systems (humanoid3d and G1 sizes, both cones,
     nonzero lam0, batch 2048 and 1000): the explicit-J^T entry on random
     SPD systems, the parts entry on random contact-Jacobian parts
  3. main path: a batch of 2048 humanoid3d walk envs under a seeded
     ActorCritic that samples actions. First the kernel's inputs of one
     step (the contact-Jacobian parts) are recorded; the parts entry is
     held against build_jt + its plain version on them, both are timed
     with CUDA events beside the bound, and the clock variant gives the
     kernel's cycles per phase. A 16-env subset of that step is held
     against the CPU path. Then the counts are zeroed and the envs take
     64 DPEnv.step_auto_reset steps: every kernel must launch in them,
     build_jt must not run (J^T is built inside the kernel) and every
     state stays finite. Then four more steps under torch.profiler: the
     device-busy share and the device kernels that take the most time.
  4. gate replay: the committed humanoid3d walk gate actor from frame 20
     with mean actions for up to 1000 steps; reward > 90, no overflow

Then one JSON line per kernel table, and as the last line the result
object. Exits non-zero, printing no result, when no CUDA device is
present or any check fails. Imports nothing of JAX.
"""
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
JAX_GATE_REPLAY = 615.6  # JAX package replay of the same gate, CPU
TOL_KERNEL = 2e-4        # max|d|/scale, tests/test_fused_solve.py
TOL_STEP = 5e-3          # max|d|/scale, tests/test_fused_solve.py


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0, name):
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def scaled_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(a.abs().max()), 1.0))


def random_systems(seed, B, nv, K, L):
    """Random SPD systems like tests/test_fused_solve.py:_mk, batched,
    with a nonzero warm start."""
    import numpy as np

    n = 3 * K + L
    r = np.random.RandomState(seed)
    G = r.randn(B, nv, nv)
    M = G @ G.transpose(0, 2, 1) + nv * np.eye(nv)
    JT = (r.randn(B, n, nv) * (r.rand(B, n, 1) < 0.8)).transpose(0, 2, 1)
    qf = r.randn(B, nv) * 10
    aref = r.randn(B, n)
    imp = np.clip(r.rand(B, n), 0.05, 0.95)
    act_c = r.rand(B, K) < 0.5
    active = np.concatenate([act_c, act_c, act_c, r.rand(B, L) < 0.3], 1)
    mu = np.full((B, K), 1.0)
    lam0 = r.randn(B, n)
    return [np.ascontiguousarray(x, np.float32)
            for x in (M, JT, qf, aref, imp, active, mu, lam0)]


def random_parts(seed, B, nv, K, L):
    """Contact-Jacobian parts like the engine's: orthonormal contact
    frames, contact points near the root, signed 0/1 dof masks, and
    L distinct limited dofs. Returns (parts, ld_idx)."""
    import numpy as np

    r = np.random.RandomState(seed)
    frame, _ = np.linalg.qr(r.randn(B, K, 3, 3))
    parts = [r.randn(B, nv, 3), r.randn(B, nv, 3), frame,
             r.randn(B, K, 3) * 0.3, r.choice([-1.0, 0.0, 1.0], (B, K, nv)),
             np.where(r.rand(B, L) < 0.5, 1.0, -1.0)]
    ld_idx = tuple(int(i) for i in np.sort(r.choice(nv, L, replace=False)))
    return [np.ascontiguousarray(x, np.float32) for x in parts], ld_idx


def time_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from deepmimic_mujoco_tpu_torch.envs import DPEnv
    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.physics import solver
    from deepmimic_mujoco_tpu_torch.rl import networks
    from deepmimic_mujoco_tpu_torch.rl.convert import actor_from_npz
    from deepmimic_mujoco_tpu_torch.utils.device import fp32_physics

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    fp32_physics()

    # ---- 0. card ----------------------------------------------------------
    t0 = phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")
    done(t0, "card")

    # ---- 1. build -----------------------------------------------------------
    t0 = phase("build")
    tb = time.perf_counter()
    libs = fs.build_all(force=True)
    print(f"nvcc {os.path.relpath(fs.SOURCE, REPO)} -> "
          + ", ".join(os.path.relpath(p, REPO) for p in libs.values())
          + f" (in parallel): {time.perf_counter() - tb:.2f} s")
    spills = 0
    for name, log in fs.build_all.ptxas.items():
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    spills += int(m.group(1)) + int(m.group(2))
    check(spills == 0, f"ptxas reports {spills} bytes of spills")
    info = {}
    for label, (nv, K, L) in (("h3d", (34, 16, 28)), ("g1", (43, 24, 37))):
        info[label] = fs.kernel_info(nv, 3 * K + L, K, parts=True)
        pl = info[label]["plan"]
        print(f"fused_solve plan at {label} (nv={nv}, K={K}, L={L}): "
              f"{pl.threads_per_env} threads per env ({pl.tr} x {pl.tc}), "
              f"{pl.envs_per_block} env per block, {pl.w_regs} W values "
              f"per thread; {info[label]['regs']} registers, "
              f"{info[label]['spill_bytes']} local bytes, "
              f"{info[label]['smem_bytes']} B dynamic shared memory, "
              f"{info[label]['blocks_per_sm']} blocks per SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
        check(info[label]["smem_bytes"] == pl.smem_bytes,
              f"launch_plan's shared memory {pl.smem_bytes} B differs from "
              f"the kernel's {info[label]['smem_bytes']} B")
        check(info[label]["spill_bytes"] == 0, f"local memory at {label}")
    done(t0, "build")

    # ---- 2. kernel vs plain ------------------------------------------------
    t0 = phase("kernel vs plain")
    h3d = (34, 16, 28)
    for (nv, K, L), B, pyr in [(h3d, 2048, False), (h3d, 2048, True),
                               (h3d, 1000, False), ((43, 24, 37), 2048, False),
                               ((43, 24, 37), 1000, True)]:
        args = [torch.as_tensor(a, device=dev)
                for a in random_systems(B + nv, B, nv, K, L)]
        kw = dict(K=K, L=L, iterations=50, pyramidal=pyr)
        parts, ld_idx = random_parts(2 * B + nv, B, nv, K, L)
        parts = [torch.as_tensor(a, device=dev) for a in parts]
        M, JT, vectors = args[0], args[1], args[2:]
        for entry, got, ref in (
                ("explicit", lambda: fs.fused_solve(*args, **kw),
                 lambda: fs.fused_solve_plain(*args, **kw)),
                ("parts", lambda: fs.fused_solve_parts(
                    M, *parts, *vectors, ld_idx=ld_idx, **kw),
                 lambda: fs.fused_solve_plain(
                     M, fs.build_jt(*parts, ld_idx), *vectors, **kw))):
            call = got
            got = call()
            torch.cuda.synchronize()
            ref = ref()
            errs = {name: scaled_err(a, b)
                    for name, a, b in zip(("qacc", "qfrc", "lam"), ref, got)}
            abs_err = max(float((a - b).abs().max())
                          for a, b in zip(ref, got))
            print(f"{entry} nv={nv} K={K} L={L} B={B} "
                  f"{'pyramidal' if pyr else 'elliptic'}: scaled err "
                  + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                  + f" max_abs={abs_err:.2e}")
            check(all(v < TOL_KERNEL for v in errs.values()),
                  f"{entry} kernel disagrees with plain at nv={nv} B={B}: "
                  f"{errs}")
            if B == 2048 and not pyr:
                k_ms = time_ms(call, 10)
                b_ms, b_by = fs.bound_ms(B, nv, K, L, 50, entry=entry)
                print(f"  {entry} kernel at nv={nv} B={B} on {card}: "
                      f"{k_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    done(t0, "kernel vs plain")

    # ---- 3. main path -------------------------------------------------------
    t0 = phase("main path")
    n_envs, n_steps = 2048, 64
    with torch.no_grad():
        env = DPEnv(motion="walk", robot="humanoid3d", device=dev)
        net = networks.ActorCritic(
            env.obs_size, env.action_size, device="cpu",
            generator=torch.Generator().manual_seed(0)).to(dev)
        g_rsi = torch.Generator(device=dev).manual_seed(1)
        g_act = torch.Generator(device=dev).manual_seed(2)
        state, obs = env.reset(n_envs, generator=g_rsi)
        mean, log_std, _ = net(obs)
        action, _ = networks.sample_action(mean, log_std, g_act)

        # the kernel's inputs on the main path: one full-batch step with
        # the solver's parts entry recorded (outside the counted window)
        captured = []
        parts_entry = solver.fused_solve_parts

        def record(*args, **kw):
            captured.append(([a.clone() for a in args], dict(kw)))
            return parts_entry(*args, **kw)

        solver.fused_solve_parts = record
        try:
            env.step(state, action)
        finally:
            solver.fused_solve_parts = parts_entry
        main_args, main_kw = captured[0]
        plain_kw = {k: v for k, v in main_kw.items() if k != "ld_idx"}
        M_m, parts_m, vec_m = main_args[0], main_args[1:7], main_args[7:]

        def plain():   # build_jt + the plain version: the CPU path's function
            JT = fs.build_jt(*parts_m, main_kw["ld_idx"])
            return fs.fused_solve_plain(M_m, JT, *vec_m, **plain_kw)

        kernel = fs.fused_solve_parts
        got = kernel(*main_args, **main_kw)
        ref = plain()
        max_abs = max(float((a - b).abs().max()) for a, b in zip(ref, got))
        errs = {name: scaled_err(a, b)
                for name, a, b in zip(("qacc", "qfrc", "lam"), ref, got)}
        print(f"kernel vs plain on the main path's first-step inputs "
              f"(B={n_envs}): max_abs={max_abs:.3e} scaled "
              + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
        check(all(v < TOL_KERNEL for v in errs.values()),
              f"kernel disagrees with plain on main-path inputs: {errs}")
        # times there, alternating plain, kernel, kernel, plain
        ker = lambda: kernel(*main_args, **main_kw)
        p1, k1, k2, p2 = (time_ms(plain, 3), time_ms(ker, 20),
                          time_ms(ker, 20), time_ms(plain, 3))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        B_m, nv_m = M_m.shape[:2]
        b_ms, b_by = fs.bound_ms(B_m, nv_m, main_kw["K"], main_kw["L"],
                                 iterations=main_kw["iterations"],
                                 entry="parts")
        print(f"fused_solve_parts h3d B={n_envs} on {card}: kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain (build_jt + fused_solve_plain)"
              f" {p1:.4f} / {p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / k_ms:.1f}% of the bound")
        # waves: one env is one block, so B beyond blocks-per-SM x SMs
        # adds a wave of the same length
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        per_wave = sms * info["h3d"]["blocks_per_sm"]
        waves = []
        for b in (sms, per_wave, B_m):
            sub_args = [a[:b] for a in main_args]
            waves.append((b, time_ms(lambda: kernel(*sub_args, **main_kw),
                                     20)))
        print(f"fused_solve_parts time by batch ({sms} SMs x "
              f"{info['h3d']['blocks_per_sm']} blocks = {per_wave} envs per "
              f"wave): " + ", ".join(f"B={b} {t:.4f} ms" for b, t in waves))
        # inside the kernel: clock64() per phase, from the clock variant
        clocks = fs.phase_cycles(*main_args, **main_kw)
        cyc = (clocks[:, 1:] - clocks[:, :-1]).double().mean(0).tolist()
        total = sum(cyc)
        print(f"fused_solve phase cycles per env (mean of {B_m}, thread 0; "
              f"{total:.0f} in all): " + ", ".join(
                  f"{name} {c:.0f} ({100 * c / total:.1f}%)"
                  for name, c in zip(fs.PHASES, cyc)))
        check(all(c > 0 for c in cyc), f"phase clocks not increasing: {cyc}")

        # first step of a 16-env subset against the port's CPU path
        sub = lambda s: type(s)(*[x[:16] for x in s])
        s_gpu, o_gpu = env.step(sub(state), action[:16])
        cpu_env = DPEnv(motion="walk", robot="humanoid3d", device="cpu")
        s_cpu, o_cpu = cpu_env.step(
            type(state)(*[x[:16].cpu() for x in state]), action[:16].cpu())
        errs = {k: scaled_err(getattr(s_cpu, k), getattr(s_gpu, k))
                for k in ("qpos", "qvel")}
        errs.update({k: scaled_err(getattr(o_cpu, k), getattr(o_gpu, k))
                     for k in ("obs", "reward")})
        print("first step, 16 envs, card vs CPU path: scaled err "
              + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
        check(all(v < TOL_STEP for v in errs.values()),
              f"card step disagrees with the CPU path: {errs}")
        check(bool((o_cpu.done == o_gpu.done.cpu()).all()),
              "done flags differ between card and CPU")

        torch.cuda.synchronize()
        jt_builds = []
        build_jt = fs.build_jt
        fs.build_jt = lambda *a, **k: jt_builds.append(1) or build_jt(*a, **k)
        fs.fused_solve.launches = 0
        tm = time.perf_counter()
        finite = torch.ones((), dtype=torch.bool, device=dev)
        n_done = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(n_steps):
            state, out = env.step_auto_reset(state, action, g_rsi)
            finite &= (torch.isfinite(state.qpos).all()
                       & torch.isfinite(state.qvel).all()
                       & torch.isfinite(out.obs).all())
            n_done += out.done.sum()
            mean, log_std, _ = net(out.obs)
            action, _ = networks.sample_action(mean, log_std, g_act)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tm
        launches = {"fused_solve": fs.fused_solve.launches}
        fs.build_jt = build_jt
    print(f"launches in {n_steps} steps: {launches}; build_jt calls: "
          f"{len(jt_builds)}")
    check(not jt_builds, "build_jt ran on the card's main path")
    check(launches["fused_solve"] == n_steps,
          f"fused_solve launched {launches['fused_solve']} times in "
          f"{n_steps} steps")
    check(bool(finite), "non-finite state on the main path")
    # where the time goes: a short profiled window of the same loop
    prof_steps = 4
    with torch.no_grad(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        for _ in range(prof_steps):
            state, out = env.step_auto_reset(state, action, g_rsi)
            mean, log_std, _ = net(out.obs)
            action, _ = networks.sample_action(mean, log_std, g_act)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - tp) * 1e6
    kern_ev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    busy_us = sum(dev_us(e) for e in kern_ev)
    n_kernels = sum(e.count for e in kern_ev)
    print(f"profile, {prof_steps} steps on {card}: device busy "
          f"{busy_us / 1e3:.3f} ms of {prof_wall_us / 1e3:.3f} ms wall "
          f"({100 * busy_us / prof_wall_us:.1f}%), "
          f"{n_kernels / prof_steps:.0f} device kernels per step")
    for e in sorted(kern_ev, key=dev_us, reverse=True)[:8]:
        print(f"  {dev_us(e) / prof_steps / 1e3:8.4f} ms/step "
              f"{e.count // prof_steps:5d}/step  {e.key[:90]}")
    print(f"main path on {card}: {n_envs} envs x {n_steps} steps in "
          f"{wall:.3f} s = {n_envs * n_steps / wall:.1f} env-steps/s "
          f"(policy + sampling + step_auto_reset; {int(n_done)} resets)")
    done(t0, "main path")

    # ---- 4. gate replay -----------------------------------------------------
    t0 = phase("gate replay")
    with torch.no_grad():
        actor = actor_from_npz(os.path.join(
            REPO, "deepmimic_mujoco_tpu_torch", "data",
            "h3d_walk_gate_actor.npz"), device=dev)
        state, obs = env.reset(1, idx_init=20)
        total, ov, ep_len = 0.0, 0, 0
        for ep_len in range(1, 1001):
            mean, _, _ = actor(obs)
            state, out = env.step(state, mean)
            total += float(out.reward[0])   # the done step counts
            ov = max(ov, int(out.contact_overflow[0]))
            obs = out.obs
            if bool(out.done[0]):
                break
    print(f"gate replay on {card}: reward {total:.2f} over {ep_len} steps "
          f"(JAX replay {JAX_GATE_REPLAY}), max contact overflow {ov}")
    check(total > 90.0, f"gate reward {total:.2f} <= 90")
    check(ov == 0, f"gate episode dropped {ov} active contacts")
    done(t0, "gate replay")

    kernels = [{
        "name": "fused_solve",
        "route": "cuda",
        "source": "deepmimic_mujoco_tpu_torch/ops/csrc/fused_solve.cu",
        "replaces": "deepmimic_mujoco_tpu/ops/fused_solve.py:67",
        "launches": launches["fused_solve"],
        "max_abs_err": max_abs,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "regs": info["h3d"]["regs"],
        "spills": spills,
        "smem_bytes": info["h3d"]["smem_bytes"],
        "blocks_per_sm": info["h3d"]["blocks_per_sm"],
    }]
    print(f"total: {time.perf_counter() - t_all:.2f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
