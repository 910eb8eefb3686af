"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --data-parallel     # the build and phase 13 only
    python3 chip_smoke.py --contact-rich      # the build and phase 16 only

Phases, each printed with its seconds:
  0. card: name and power limit (nvidia-smi), torch's device name, and
     whether cv2 and matplotlib are present: a part that draws with an
     absent one is left out, and the line says which
  1. build: nvcc of every kernel source of the main path and of the
     fused solve's phase-clock variant, four translation units of each,
     all started together, then one link each; ptxas's registers and
     spills (any spill fails the run), and the registers, shared memory
     and blocks per SM that the occupancy calculator gives at humanoid3d
     and G1 sizes: the register plans at 16 and 24 contact slots, the
     shared-memory plan's instances at G1 26, 48 and 128, humanoid3d 128
     and 60 dofs
  2. kernel vs plain: both fused-solve entries against the plain torch
     version on random systems (humanoid3d and G1 sizes, both cones,
     nonzero lam0, batch 2048 and 1000): the explicit-J^T entry on random
     SPD systems, the parts entry on random contact-Jacobian parts
  3. main path: a batch of 2048 humanoid3d walk envs under a seeded
     ActorCritic that samples actions. First the kernel's inputs of one
     step (the contact-Jacobian parts) are recorded; the parts entry is
     held against build_jt + its plain version on them, evaluated in
     float64 (scaled by the batch's and by each env's largest value,
     beside what a wrong kernel would read and the float32 plain
     version's own distance), the kernel and the float32 plain version
     are timed
     with CUDA events beside the bound, and the clock variant gives the
     kernel's cycles per phase. A 16-env subset of that step is held
     against the CPU path. Then the counts are zeroed and the envs take
     64 DPEnv.step_auto_reset steps: every kernel must launch in them,
     build_jt must not run (J^T is built inside the kernel) and every
     state stays finite. Then four more steps under torch.profiler: the
     device-busy share and the device kernels that take the most time.
  4. G1 main path: 2048 Unitree G1 walk envs under a seeded ActorCritic
     that samples actions. The kernel (G1 plan) is held against its
     plain version on the first step's inputs, as in phase 3, and both
     are timed; then
     64 step_auto_reset steps with the counts zeroed: 64 launches, no
     build_jt; env-steps/s and the largest contact overflow
  5. PPO training: the ported CLI's main() in-process on G1 walk at its
     default widths for two iterations (--total 262144), rendering as its
     default does (--no-render only where cv2 or matplotlib is absent):
     the first evaluation's dashboard video (at least one frame, read
     back with cv2) and both plots under build/ppo_smoke; per iteration
     the rollout and update times, env-steps/s, losses, KL and overflow;
     losses finite, params moved, 64 launches per iteration in the
     training thread (the kernel's count for that thread, zeroed just
     before each iteration), at least one finished evaluation with one
     launch per step in the evaluator thread, and no failed evaluation.
     Then the train state is saved, restored, and one more iteration
     from it must equal one continued without the round trip (losses
     within 1e-5 relative). Last, one update minibatch step under
     torch.profiler, and the optimizer step beside
     torch.optim.Adam(fused=True)
  6. combined main path: 2048 combined walk/run/getup envs (Unitree G1)
     under a seeded ActorCritic that samples actions, with the handoff
     buffer armed (HANDOFF_BUFFER_FRAC 0.25, FACEDOWN_RSI_FRAC 0.1,
     RSI_RANDOM_PA) and updated each step as the PPO rollout does. The
     kernel (G1 plan) is held against its plain version on the first
     step's inputs and timed, as in phase 3; then 64 step_auto_reset
     steps with the counts zeroed: 64 launches, env-steps/s, overflow,
     the count of each motion transition and handoff_count
  7. RK4 main path: 2048 humanoid3d walk envs under RK4 for 16 steps:
     the kernel held against its plain version on the first stage's
     inputs (lam0 = 0) and timed, then 4 launches per step
  8. PPO on the combined env: the CLI's main() with its default --env,
     --handoff-buffer 0.25 and --facedown-rsi 0.1, at its default widths
     for two iterations: as phase 5 (without the round trip), and the
     buffer holds rows after the iterations
  9. SAC main path: 256 humanoid3d walk envs (SAC's default n_envs, one
     partial wave of the kernel) under a seeded SAC actor that samples
     squashed actions; the kernel is held against its plain version on
     the first collect step's inputs and timed, as in phase 3
 10. SAC training: the SAC CLI's main() at its default widths (256 envs,
     a 1,000,000-row replay buffer, batch 1024, 32 steps and 32 updates
     an iteration, nets (1024, 512)) for two iterations with an
     evaluation after each: 32 launches per iteration in the training
     thread, env-steps/s with the collect and the updates apart, the
     buffer's bytes, finite losses, alpha >= exp(log_alpha_min), the
     best actor written; then one update step under torch.profiler
 11. SAC distill: distill_actor_from_ppo from the h3d walk gate actor at
     its defaults (4096 envs x 64 steps, 3000 BC steps): the kernel held
     and timed on the rollout's first-step inputs, 64 launches, the BC
     loss ending below its step-0 value; the distilled actor is kept for
     its replay
 12. tools: profiling.stage_breakdown at humanoid3d B 2048 (env.step
     and its stages timed in place by the program's spans, the kernel
     launched once a step) and profiling.throughput_sweep at B 256,
     1024, 2048 and 4096; then the kernel held and timed at B 1, the batch of
     the rendered paths, once per plan: on the first step with an
     active row of the h3d walk gate actor (the dashboard, the viewer's
     policy) and of the extracted G1 run artifact (play, play --video)
 13. data parallel: the training CLI's PPO on its default combined env
     (--handoff-buffer 0.25 --facedown-rsi 0.1) at its default widths
     (2048 x 64, 20 epochs x 32 minibatches of 4096, net (256, 128)),
     one seed, unsharded and through deepmimic_mujoco_tpu_torch.parallel:
     world 1 over NCCL in this process, and world 2 over gloo with both
     ranks on the one card (spawned by parallel.dryrun.launch; NCCL
     refuses two ranks on one device, so gloo is asked for by name: a
     correctness path, not a scaling number). Each world is held against
     the unsharded runs: the update alone on the unsharded rollout's
     batch for its first epoch (losses 1e-4, params 5e-4 scaled, the
     tolerances of tests/test_multichip.py: the gate), the first step
     per env (its sampled action and the obs after it, TOL_KERNEL); the
     update's 20 epochs and the whole iteration are printed beside the
     unsharded runs from params moved by 1e-7 (at these widths the
     update itself turns a 1e-7 move into ~1e-1 scaled over 640 steps)
     and beside the prediction. Per rank: 64 launches an iteration, the collectives
     (all_reduce count against 2 + epochs + gradient steps, 65
     all_gathers), the bytes and seconds of the trajectory gather and
     the handoff-row gathers, replicas equal bit for bit, env-steps/s.
     On a machine with several cards (``--data-parallel``, which runs
     the build and this phase alone), a world of every card over NCCL
     is held the same way. Each spawned world's ranks then save their
     state after the iteration (rl/checkpoint.py: every rank gathers its
     env rows, rank 0 writes, a barrier), printing the gathers' bytes
     and seconds, and the file, restored unsharded here, must equal the
     ranks' state (their env rows in rank order, rank 0's replicated
     leaves) bit for bit. Then the kernel held and timed on rank 0's
     first-step inputs (B 1024, G1 plan)
 14. gate replays, each in a process of its own (``--replay NAME``),
     all started together (each is host-bound), with mean actions; a
     batch replay reads its alive flags every 50 steps and stops once
     every episode has ended:
     - the humanoid3d walk gate actor from frame 20 and the three G1
       gate actors (walk and run from frame 20, getup from frame 0), each
       above its gate (90, 90, 90, 60) with no overflow, beside the JAX
       replay; and the G1 getup gate actor again at 128 contact slots
       (``--replay g1_getup_k128``, the shared-memory plan; held in
       phase 16)
     - the RK4 walk gate actor from frame 20 for 1000 steps: reward > 90,
       no overflow, 4 launches per step
     - the combined actor from the reset the JAX package draws from
       PRNGKey(0) (data/combined_gate_start.npz) and from 31 copies of
       it with the start velocity moved by 1e-5 x N(0, 1), as one batch
       of 32 for up to 2000 steps; each episode
       against the bar (reward > 100, length >= 1900, no overflow); the
       median reward must exceed 100 and 8 episodes clear the bar; one
       launch per step
     - tools/play_combined.main with the combined actor, a 520-step
       force-tracked warm start and a fall injected at step 520: the fall
       -> to_getup -> getup path must run, and each physics step launches
       the kernel once
     - the SAC walk gate actor (data/sac_walk_gate_actor.npz) and the
       actor distilled in phase 11, as one batch of 2 from frame 20 for
       up to 1000 steps under tanh(mean): the gate actor's reward > 50
       (the JAX package's scan: 67.52 over 380 steps), the distilled
       one's printed (no gate), one launch per step
     - tools/play.main on data/run_extracted.npz (G1 run, through
       GymDPEnv and the numpy ExtractedPolicy, golden test first) with
       --assert-reward 90, one launch per step
     - the render paths: the ray tracer built by g++ into
       build/torch_kernels/librasterizer.so; render_state of humanoid3d
       and G1 with FK on the card against FK on the CPU path (at most
       0.1% of the pixels differ, frame std > 20) and its ms per frame at
       320x240 and 480x480 (median of 5); the viewer's frames from the
       clip and from the h3d walk gate actor's policy (one launch per
       policy frame, consecutive frames differ); the eval dashboard of
       that actor over 60 steps (one launch per step, the best params,
       the video and plots); play --video of the extracted run artifact
       over 100 steps; check_debug_log --video of a dump GymDPEnv wrote
       on the card; retarget of walk into a writable asset root under
       build/ and validate_clip of it on the card (mean > 0.9; its steps
       force the state, so the kernel launches 0 times)
     The play_combined replay renders every 4th step (--video).
 15. fine-tune recipes: the training CLI's main() on the two recorded
     fine-tune recipes, warm-started from the JAX package's params
     directories as tools/export_params.py --all exports them into
     deepmimic_mujoco_tpu_torch/data/: r5b (tools/train_queue_r5b.sh,
     the combined env with the handoff buffer, from combined_r4_best)
     and F2 (tools/train_queue_r5c.sh, G1 run from the G1 walk best, no
     warm start of the solve, one subcapsule per mesh link), each at
     2048 x 128, 10 epochs x 64 minibatches of 4096, net (256, 128), for
     two iterations (the callback's evaluation at iteration 0 runs
     beside them). Per recipe: the net before the first update equals
     the exported file bit for bit with log_std reset; the engine's
     options and the first step's solve (plan, K, L; for F2 lam0 = 0);
     the kernel held against its plain version on those inputs and
     timed, as in phase 3; 128 launches per iteration in the training
     thread; per iteration env-steps/s with the rollout and the update
     apart, finite losses, KL and clip fraction, and r/step, ep_len and
     KL beside the JAX package's log of the same recipe (printed, not
     held); for r5b the handoff buffer holds rows afterwards
 16. contact-rich: the kernel's shared-memory plan (the sizes no
     register plan holds). (a) Both entries, both cones, on random
     systems at B 2048 of G1 (nv 43, L 37) at 26, 48, 64 and 128 contact
     slots and humanoid3d (nv 34, L 28) at 29, 32 and 128, held against
     the plain version in float64 (by the batch and by each env, the
     float32 plain version's distance beside it) and timed beside the
     bound; each size's instance with its registers, spills, shared
     bytes and blocks per SM, the parts entry's time by batch (one env
     an SM, one wave, 2048) and its cycles per phase.
     (b) The nine G1 states of tests/test_torch_g1.py's fixture (walk
     poses, jittered and sunk ones, the prone getup pose sunk 6 cm)
     tiled to B 2048, one Euler step at 128 slots: the active contacts,
     no overflow (the prone env drops contacts at 24), the kernel held
     and timed on the step's inputs as in phase 3, and the nine envs
     against the port's CPU path (TOL_STEP). (c) 2048 G1 getup envs at
     128 slots under a seeded ActorCritic, the kernel held on the first
     step's inputs, then 64 step_auto_reset steps with the counts
     zeroed: 64 launches, all of the shared-memory plan, no build_jt,
     finite states; the overflow summed and env-steps/s beside the same
     rollout at 24 slots and phase 4. (d) The kernel held at B 1 on the
     getup gate actor's first step at 128 slots, and that gate's replay
     from phase 14: reward > 60, no overflow, one launch per step,
     beside the same actor at 24 slots

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
TOL_KERNEL = 2e-4        # max|d|/scale, tests/test_fused_solve.py
TOL_STEP = 5e-3          # max|d|/scale, tests/test_fused_solve.py
TOL_RESUME = 1e-5        # relative, resumed vs continued PPO losses
# the training CLI at its default widths, two iterations of G1 walk, the
# first evaluation rendering its dashboard as the CLI's default does
PPO_ARGV = ["chip smoke", "--env", "deep_mimic_mujoco", "--motion", "walk",
            "--robot", "unitree_g1", "--no-wandb", "--total", "262144"]
TOL_PIXELS = 1e-3        # share of pixels, tests/test_torch_render.py
# the combined gate (tests/test_checkpoint_gates.py:135): the actor,
# its reward and length bars, the JAX package's replay of it
COMBINED_GATE = ("combined_r5_best_actor.npz", 100.0, 1900, 154.2)
COMBINED_STEPS = 2000        # the combined env's MAX_EP_LENGTH
# Whether this policy falls within 2000 steps turns on rounding: the
# JAX package's own replays of the same start part ways (its scan 154.2,
# its vmapped replay 21.17 over 656 steps; tools/combined_gate_spread.py).
# So the gate replays the start 32 times at once, 31 of them with the
# start velocity moved by 1e-5 x N(0, 1), and asks that the median
# clears 100 and at least 8 episodes clear the whole bar (the JAX
# package: 23 of 32 clear reward and length).
COMBINED_REPLAYS = 32
COMBINED_NOISE = 1e-5
COMBINED_MIN_PASS = 8
# the RK4 walk gate (tests/test_checkpoint_gates.py:37-39)
RK4_GATE = ("h3d_walk_rk4_gate_actor.npz", 20, 90.0, 655.2)
# PPO on the CLI's default (combined) env with the handoff buffer armed
PPO_COMBINED_ARGV = ["chip smoke", "--no-wandb", "--no-render",
                     "--total", "262144", "--handoff-buffer", "0.25",
                     "--facedown-rsi", "0.1"]
# the warm start force-tracks the clip past any reset (the getup clip
# runs 353 steps, then 151 of locomotion earn amnesty), so the fall at
# step 520 always lands, and to_getup ends within its 180 steps
PLAY_ARGV = ["--steps", "720", "--warmstart", "520",
             "--inject-fall-every", "40"]
# the gate replays, each in a process of its own: (actor file, motion,
# robot, start frame, gate, JAX package replay), from
# tests/test_checkpoint_gates.py
GATES = {
    "h3d_walk": ("h3d_walk_gate_actor.npz", "walk", "humanoid3d", 20, 90.0,
                 615.6),
    "g1_walk": ("g1_walk_gate_actor.npz", "walk", "unitree_g1", 20, 90.0,
                324.3),
    "g1_run": ("g1_run_gate_actor.npz", "run", "unitree_g1", 20, 90.0,
               123.79),
    "g1_getup": ("g1_getup_gate_actor.npz", "getup_facedown_slow_FSI",
                 "unitree_g1", 0, 60.0, 69.4),
}
# the SAC walk gate (tests/test_checkpoint_gates.py:280-315): the actor,
# its start frame, gate and the JAX package's replay (its scan on the
# CPU: 67.52 over 380 steps; 16 starts moved by 1e-5 in velocity give
# 67.48-67.54)
SAC_GATE = ("sac_walk_gate_actor.npz", 20, 50.0, 67.52)
# the SAC CLI at its default widths (256 envs, buffer 1,000,000, batch
# 1024, 32 steps and 32 updates an iteration, arch (1024, 512)) for two
# iterations, with an evaluation after each
SAC_PER_ITER = 256 * 32
SAC_ARGV = ["chip smoke", "--total", str(2 * SAC_PER_ITER),
            "--eval-every", str(SAC_PER_ITER)]
# the distill's teacher, and where its student is kept for the replay
DISTILL_TEACHER = "h3d_walk_gate_actor.npz"
DISTILLED = os.path.join(REPO, "build", "sac_smoke", "distilled_actor.npz")
# tools/play.main on the extracted G1 run artifact, with its gate (the
# artifact holds the run_r5_default_gate weights, tests/test_checkpoint_
# gates.py:230-277)
PLAY_EXTRACTED_ARGV = ["--checkpoint", os.path.join(
    REPO, "deepmimic_mujoco_tpu_torch", "data", "run_extracted.npz"),
    "--motion", "run", "--robot", "unitree_g1", "--assert-reward", "90"]
SWEEP_BATCHES = (256, 1024, 2048, 4096)
# the contact-rich phase: the contact slots the shared-memory plan is
# held at on the engine's paths, the random systems of its sizes (G1 nv
# 43, L 37; humanoid3d nv 34, L 28), the G1 gate replayed at those slots
# (beside the same actor at the default 24), and the rollout's clip
CONTACT_RICH_K = 128
CONTACT_RICH_RANDOM = (("g1", 43, 26, 37), ("g1", 43, 48, 37),
                       ("g1", 43, 64, 37), ("g1", 43, 128, 37),
                       ("h3d", 34, 29, 28), ("h3d", 34, 32, 28),
                       ("h3d", 34, 128, 28))
GATES_K128 = {"g1_getup_k128": "g1_getup"}
GETUP_MOTION = "getup_facedown_slow_FSI"
REPLAYS = (*GATES, *GATES_K128, "combined", "rk4", "play_combined", "sac",
           "play_extracted_run", "render")
RENDER_DIR = os.path.join(REPO, "build", "render_smoke")
# the render job: the frames the viewer steps from each source, the
# dashboard's episode cap and play --video's steps
VIEW_FRAMES, DASHBOARD_STEPS, PLAY_VIDEO_STEPS = 10, 60, 100
REPLAY_TIMEOUT = 900
# the data-parallel phase: the training CLI's default (combined) env with
# the handoff buffer armed, at the CLI's default PPO widths, one seed
DP_ARGV = ["chip smoke", "--no-wandb", "--no-render", "--handoff-buffer",
           "0.25", "--facedown-rsi", "0.1"]
DP_SEED = 0
TOL_DP_LOSS = 1e-4       # |d| / max(|loss|, 1), tests/test_multichip.py
TOL_DP_PARAM = 5e-4      # max|d| / max(max|p|, 1e-3), the same test
# the whole iteration's divergence from the unsharded one, by world:
# (stats relative, params scaled), predicted before the first run
# (PERF.md section 6, the data-parallel slice; a world of every card,
# where there are several, takes world 2's); printed, not held
DP_PREDICTED = {1: (0.0, 0.0), 2: (1e-3, 1e-3)}
# the recorded fine-tune recipes (tools/train_queue_r5b.sh:11-19, and
# tools/train_queue_r5c.sh:22-33, leg F2) through the training CLI at
# their widths (2048 x 128, 10 epochs x 64 minibatches of 4096, net (256,
# 128)) for two iterations, each warm-started from the JAX package's
# params directory as tools/export_params.py --all exports it. Per
# recipe: its own flags, the exported file, the reset log_std, and the
# JAX package's log of the same recipe, iterations 0 and 1 (r/step,
# ep_len, kl; runs/q_r5_combined_hbuf.log, runs/q_r5_run_cold_F2.log):
# other random streams, so printed beside, not held
RECIPE_WIDTHS = (2048, 128, 4096, 10)    # n_envs, horizon, minibatch, epochs
RECIPE_ITER = RECIPE_WIDTHS[0] * RECIPE_WIDTHS[1]
RECIPE_ARGV = ["--no-wandb", "--no-render", "--adaptive-lr", "--target-kl",
               "0.012", "--epochs", "10", "--log-std-min", "-1.5",
               "--eval-every", "4000000", "--horizon", "128", "--total",
               str(2 * RECIPE_ITER)]
RECIPES = {
    "r5b": (["--env", "dp_combined_env", "--handoff-buffer", "0.25",
             "--handoff-rsi", "0.1", "--rsi-random-pa", "--lr", "1e-4"],
            "combined_r4_best_params.pt", -1.2,
            ((0.035, 90.0, 0.0172), (0.014, 148.1, 0.0195))),
    "f2": (["--env", "deep_mimic_mujoco", "--motion", "run", "--robot",
            "unitree_g1", "--no-warm-start-lam", "--mesh-subcapsules", "1",
            "--alive-bonus", "0.3", "--alive-bonus-decay", "120000000",
            "--vel-shaping", "0.4", "--lr", "2.5e-4"],
           "g1_walk_best_params.pt", -0.7,
           ((0.030, 18.5, 0.0174), (0.028, 18.6, 0.0169))),
}


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


def env_scaled_err(ref, got):
    """Each env held to its own scale: the largest over envs of
    max|d| / max(max|ref|, 1) within the env."""
    d = (ref.double() - got.double()).abs().flatten(1).amax(1)
    scale = ref.double().abs().flatten(1).amax(1).clamp(min=1.0)
    return float((d / scale).max())


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


def capture_solve(fn):
    """Call fn() with the solver's parts entry recorded: the kernel's
    inputs of its first solve. Returns (args, kwargs)."""
    from deepmimic_mujoco_tpu_torch.physics import solver

    captured = []
    parts_entry = solver.fused_solve_parts

    def record(*args, **kw):
        captured.append(([a.clone() for a in args], dict(kw)))
        return parts_entry(*args, **kw)

    solver.fused_solve_parts = record
    try:
        fn()
    finally:
        solver.fused_solve_parts = parts_entry
    return captured[0]


def capture_parts(env, state, action):
    """One full-batch env.step with the solver's parts entry recorded:
    the kernel's inputs on the main path. Returns (args, kwargs)."""
    return capture_solve(lambda: env.step(state, action))


def kernel_on_main_path(label, card, args, kw):
    """Hold the parts entry against build_jt + the plain version on the
    main path's inputs, evaluated in float64 (the function's value: the
    float32 plain version carries its own rounding, which the 50 sweeps
    of a partial solve can amplify on a sensitive system; it is printed
    beside), then time the kernel and the float32 plain version (plain,
    kernel, kernel, plain). Returns the numbers of the kernels line."""
    import torch

    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs

    plain_kw = {k: v for k, v in kw.items() if k != "ld_idx"}

    # build_jt + the plain version: the CPU path's function
    def plain(a=args):
        return fs.fused_solve_plain(
            a[0], fs.build_jt(*a[1:7], kw["ld_idx"]), *a[7:], **plain_kw)

    got = fs.fused_solve_parts(*args, **kw)
    ref = plain([a.to(torch.float64) for a in args])
    ref32 = plain()
    names = ("qacc", "qfrc", "lam")
    max_abs = max(float((a - b).abs().max()) for a, b in zip(ref, got))
    errs = {k: scaled_err(a, b) for k, a, b in zip(names, ref, got)}
    env_errs = {k: env_scaled_err(a, b) for k, a, b in zip(names, ref, got)}
    B, nv = args[0].shape[:2]
    print(f"kernel vs plain (float64) on the {label} main path's first-step "
          f"inputs (B={B}): max_abs={max_abs:.3e}; scaled by the batch's max "
          + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + "; scaled by each env's max "
          + " ".join(f"{k}={v:.2e}" for k, v in env_errs.items()))
    print("  beside it, each env scaled by its max: the plain version in "
          "float32 vs float64 " + " ".join(
              f"{k}={env_scaled_err(a, b):.2e}"
              for k, a, b in zip(names, ref, ref32))
          + "; the kernel vs the plain version in float32 " + " ".join(
              f"{k}={env_scaled_err(a, b):.2e}"
              for k, a, b in zip(names, ref32, got)))
    # what a wrong kernel would read: another env's results, or an error
    # as large as the output's mean |entry| in one entry of every env
    for k, r in zip(names, ref):
        a = r.double().abs()
        typical = r.clone()
        typical[:, 0] += float(a.mean())
        wrong = {"mean |entry| added": env_scaled_err(r, typical)}
        if B > 1:
            wrong["envs shifted by one"] = env_scaled_err(r, r.roll(1, 0))
        print(f"  {k}: |ref| max {float(a.max()):.4g} median "
              f"{float(a.median()):.4g} mean {float(a.mean()):.4g}; a "
              f"wrong kernel would read " + ", ".join(
                  f"{v:.2e} ({w})" for w, v in wrong.items()))
        check(all(v > TOL_KERNEL for v in wrong.values()),
              f"the {TOL_KERNEL} limit would pass a wrong {k}: {wrong}")
    check(all(v < TOL_KERNEL for v in errs.values())
          and all(v < TOL_KERNEL for v in env_errs.values()),
          f"kernel disagrees with plain (float64) on {label} main-path "
          f"inputs: {errs} {env_errs}")
    ker = lambda: fs.fused_solve_parts(*args, **kw)
    p1, k1, k2, p2 = (time_ms(plain, 3), time_ms(ker, 20),
                      time_ms(ker, 20), time_ms(plain, 3))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    b_ms, b_by = fs.bound_ms(B, nv, kw["K"], kw["L"],
                             iterations=kw["iterations"], entry="parts")
    plan = fs.launch_plan(nv, 3 * kw["K"] + kw["L"], kw["K"])
    print(f"fused_solve_parts {label} B={B} (plan {plan.label}) on "
          f"{card}: kernel {k1:.4f} / {k2:.4f} ms, plain (build_jt + "
          f"fused_solve_plain) {p1:.4f} / {p2:.4f} ms, bound {b_ms:.4g} ms "
          f"({b_by}), {100 * b_ms / k_ms:.3g}% of the bound")
    return dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by)


def rollout_counted(env, net, state, action, n_steps, g_rsi, g_act,
                    step=None, per_step=1):
    """n_steps of step_auto_reset under the sampled policy with the
    kernel's count zeroed just before; build_jt must not run, and the
    kernel must launch ``per_step`` times a step. ``step(state, action)``
    replaces env.step_auto_reset(state, action, g_rsi). Returns (state,
    action, launches, wall seconds, resets, max overflow)."""
    import torch

    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.rl import networks

    if step is None:
        step = lambda s, a: env.step_auto_reset(s, a, g_rsi)
    dev = state.qpos.device
    torch.cuda.synchronize()
    jt_builds = []
    build_jt = fs.build_jt
    fs.build_jt = lambda *a, **k: jt_builds.append(1) or build_jt(*a, **k)
    fs.fused_solve.launches = 0
    fs.fused_solve.launches_by_plan.clear()
    try:
        tm = time.perf_counter()
        finite = torch.ones((), dtype=torch.bool, device=dev)
        n_done = torch.zeros((), dtype=torch.int64, device=dev)
        ov = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(n_steps):
            state, out = step(state, action)
            finite &= (torch.isfinite(state.qpos).all()
                       & torch.isfinite(state.qvel).all()
                       & torch.isfinite(out.obs).all())
            n_done += out.done.sum()
            ov = torch.maximum(ov, out.contact_overflow.max())
            mean, log_std, _ = net(out.obs)
            action, _ = networks.sample_action(mean, log_std, g_act)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tm
        launches = fs.fused_solve.launches
    finally:
        fs.build_jt = build_jt
    print(f"launches in {n_steps} steps: {launches}; build_jt calls: "
          f"{len(jt_builds)}")
    check(not jt_builds, "build_jt ran on the card's main path")
    check(launches == per_step * n_steps,
          f"fused_solve launched {launches} times in {n_steps} steps")
    check(bool(finite), "non-finite state on the main path")
    return state, action, launches, wall, int(n_done), int(ov)


def replay_masked(env, act, state, obs, max_steps, check_every=50):
    """Deterministic episodes of up to ``max_steps`` steps under
    ``act(obs)``, one per env of the batch: each env's reward and largest
    contact overflow while it is alive (the done step included), as the
    gate tests' scans count them. The host reads the batch's alive flags
    every ``check_every`` steps (no sync in between) and stops once every
    episode has ended, which changes no count. Returns (reward, max
    overflow, episode length) as numpy arrays, one entry per env, and
    the steps run."""
    import torch

    n, dev = obs.shape[0], obs.device
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    total = torch.zeros(n, device=dev)
    length = torch.zeros(n, dtype=torch.int64, device=dev)
    ov = torch.zeros(n, dtype=torch.int64, device=dev)
    steps = 0
    with torch.no_grad():
        while steps < max_steps:
            state, out = env.step(state, act(obs))
            total += out.reward * alive
            length += alive
            ov = torch.maximum(ov, out.contact_overflow * alive)
            alive &= ~out.done
            obs = out.obs
            steps += 1
            if steps % check_every == 0 and not bool(alive.any()):
                break
    return (total.cpu().numpy(), ov.cpu().numpy(), length.cpu().numpy(),
            steps)


def perturbed_qvel(qvel0, n, noise):
    """(n, nv) start velocities: row 0 unchanged, the others moved by
    ``noise`` times a RandomState(0) standard normal, in float32 (the
    recipe of tools/combined_gate_spread.py)."""
    import numpy as np

    qvel0 = np.asarray(qvel0, np.float32)
    d = (np.random.RandomState(0).randn(n - 1, qvel0.shape[0])
         * noise).astype(np.float32)
    return np.concatenate([qvel0[None], qvel0[None] + d])


def combined_rollout(env, net, state, action, n_steps, g_rsi, g_act):
    """The combined main path: step_auto_reset with the handoff buffer
    armed and updated each step as the PPO rollout updates it, the
    motion transitions counted on the card. Returns rollout_counted's
    tuple, the buffer and the (4, 4) transition counts."""
    import torch

    dev = state.qpos.device
    buf = env.make_handoff_buffer()
    trans = torch.zeros(16, dtype=torch.int64, device=dev)

    def step(s, a):
        nonlocal buf, trans
        prev, pa = s.motion_id, s.player_action
        s, out = env.step_auto_reset(s, a, g_rsi, handoff_buf=buf)
        buf = env.update_handoff_buffer(
            buf, env.handoff_capture_mask(prev, out), s.qpos, s.qvel, pa,
            out.motion_id)
        trans += torch.bincount(prev * 4 + out.motion_id, minlength=16)
        return s, out

    res = rollout_counted(env, net, state, action, n_steps, g_rsi, g_act,
                          step=step)
    return res, buf, trans.view(4, 4).cpu()


def replay_job(name):
    """One gate replay, run in a process of its own (``chip_smoke.py
    --replay NAME``): its lines, then a last line ``REPLAY_RESULT`` with
    the numbers the parent checks. Each replay is host-bound (one env,
    or one small batch, ~2000-2600 kernel launches a step), so the
    parent runs them all at once."""
    import numpy as np
    import torch

    from deepmimic_mujoco_tpu_torch.envs import DPCombinedEnv, DPEnv
    from deepmimic_mujoco_tpu_torch.models.physics_model import RK4
    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.rl.convert import (
        actor_from_npz, sac_actor_from_npz,
    )
    from deepmimic_mujoco_tpu_torch.utils.device import fp32_physics

    torch.set_num_threads(1)
    fp32_physics()
    dev = torch.device("cuda")
    data = os.path.join(REPO, "deepmimic_mujoco_tpu_torch", "data")
    fs.fused_solve.launches = 0
    fs.fused_solve.launches_by_plan.clear()
    t0 = time.perf_counter()
    if name in GATES or name in GATES_K128 or name == "rk4":
        if name == "rk4":
            actor_file, idx0, _, _ = RK4_GATE
            env = DPEnv(motion="walk", robot="humanoid3d", integrator=RK4,
                        device=dev)
        else:
            actor_file, motion, robot, idx0, _, _ = GATES[
                GATES_K128.get(name, name)]
            env = DPEnv(motion=motion, robot=robot, device=dev,
                        max_contacts=(CONTACT_RICH_K if name in GATES_K128
                                      else None))
        state, obs = env.reset(1, idx_init=idx0)
        actor = actor_from_npz(os.path.join(data, actor_file), device=dev)
        rews, ovs, lens, steps = replay_masked(
            env, lambda o: actor(o)[0], state, obs, 1000)
        res = dict(reward=float(rews[0]), overflow=int(ovs[0]),
                   length=int(lens[0]), steps=steps,
                   plans=dict(fs.fused_solve.launches_by_plan))
    elif name == "sac":
        # the SAC gate actor and the actor distilled in phase 11, as
        # envs 0 and 1 of one batch, under tanh(mean)
        env = DPEnv(motion="walk", robot="humanoid3d", device=dev)
        state, obs = env.reset(2, idx_init=SAC_GATE[1])
        gate = sac_actor_from_npz(os.path.join(data, SAC_GATE[0]),
                                  device=dev)
        distilled = sac_actor_from_npz(DISTILLED, device=dev)
        act = lambda o: torch.tanh(torch.cat([gate(o[:1])[0],
                                              distilled(o[1:])[0]]))
        rews, ovs, lens, steps = replay_masked(env, act, state, obs, 1000)
        res = dict(rewards=rews.tolist(), overflows=ovs.tolist(),
                   lengths=lens.tolist(), steps=steps)
    elif name == "combined":
        env = DPCombinedEnv(device=dev)
        start = np.load(os.path.join(data, "combined_gate_start.npz"))
        n = COMBINED_REPLAYS
        full = lambda k: np.full(n, start[k])
        state, obs = env.reset_to(
            np.tile(start["qpos"][None], (n, 1)),
            perturbed_qvel(start["qvel"], n, COMBINED_NOISE),
            full("motion_id"), full("n_steps"), full("player_action"))
        actor = actor_from_npz(os.path.join(data, COMBINED_GATE[0]),
                               device=dev)
        rews, ovs, lens, steps = replay_masked(
            env, lambda o: actor(o)[0], state, obs, COMBINED_STEPS)
        res = dict(rewards=rews.tolist(), overflows=ovs.tolist(),
                   lengths=lens.tolist(), steps=steps)
    elif name == "play_combined":
        res = play_combined_run()
    elif name == "play_extracted_run":
        res = play_extracted_run()
    elif name == "render":
        res = render_job()
    else:
        raise ValueError(f"no replay named {name}")
    res["launches"] = fs.fused_solve.launches
    res["seconds"] = time.perf_counter() - t0
    print("REPLAY_RESULT " + json.dumps(res), flush=True)


def dp_ppo(device):
    """The training CLI's PPO on DP_ARGV, its env on ``device``."""
    from deepmimic_mujoco_tpu_torch.rl import train
    from deepmimic_mujoco_tpu_torch.rl.ppo import PPO

    args = train.parse_reason(DP_ARGV)
    args.device = str(device)
    return PPO(*train.build(args))


def dp_fresh(ppo, mesh=None, perturb=0.0):
    """``ppo.init(DP_SEED)``, its params scaled by ``1 + perturb``, placed
    on ``mesh`` when given."""
    import torch

    from deepmimic_mujoco_tpu_torch.parallel import shard_train_state

    ts = ppo.init(seed=DP_SEED)
    if perturb:
        with torch.no_grad():
            for p in ts.net.parameters():
                p.mul_(1.0 + perturb)
    return ts if mesh is None else shard_train_state(ts, mesh)


def dp_update(ppo, batch, mesh=None, perturb=0.0):
    """PPO.update alone on the flattened ``batch`` from ``dp_fresh``:
    (the five mean losses, params, seconds), on the CPU."""
    import torch

    ts = dp_fresh(ppo, mesh, perturb)
    torch.cuda.synchronize()
    t = time.perf_counter()
    aux = ppo.update(ts, [x.to(ts.last_obs.device) for x in batch])
    torch.cuda.synchronize()
    return (aux.reshape(-1, 5).mean(0).cpu(),
            {k: v.detach().cpu().clone()
             for k, v in ts.net.state_dict().items()},
            time.perf_counter() - t)


def state_leaves(ts) -> dict:
    """Every leaf the train-state checkpoint holds, on the CPU, by name;
    the env-indexed ones under ``env.``."""
    import torch

    c = lambda x: x.detach().cpu().clone()
    out = {f"env.{k}": c(v) for k, v in ts.env_states._asdict().items()}
    out.update({f"env.{k}": c(getattr(ts, k))
                for k in ("last_obs", "ep_return", "ep_length")})
    out.update({f"net.{k}": c(v) for k, v in ts.net.state_dict().items()})
    for name in ("mu", "nu"):
        out.update({f"opt.{name}{i}": c(x)
                    for i, x in enumerate(getattr(ts.opt, name))})
    out["opt.count"] = torch.tensor(ts.opt.count)
    out.update({f"gen.{k}": g.get_state() for k, g in ts.gens.items()})
    out["global_step"] = torch.tensor(ts.global_step)
    out["lr_scale"] = torch.tensor(ts.lr_scale, dtype=torch.float64)
    if ts.handoff_buf is not None:
        out.update({f"buf.{k}": c(v)
                    for k, v in ts.handoff_buf._asdict().items()})
    return out


def dp_iteration(ppo, mesh=None, batch=None, perturb=0.0, save_path=None):
    """The data-parallel phase's runs of one rank (or, without ``mesh``,
    of the unsharded trainer), each from ``dp_fresh``: with ``batch`` (a
    flattened rollout batch), the update alone on it for one epoch (the
    gate) and for all of the config's epochs; then one whole iteration
    with the kernel's count zeroed just before it and read just after.
    Returns CPU tensors and numbers: the updates' (losses, params,
    seconds), and the iteration's stats, five mean losses, params,
    launches, wall seconds, collectives, gathers (dim, bytes this rank
    sends, seconds), first step (the obs after it and the sampled
    action, every env) and, unsharded, its batch. With ``save_path``
    (sharded), the state after the iteration is then saved there through
    ``rl/checkpoint.py:save``: its seconds, collectives and this rank's
    ``state_leaves``."""
    import dataclasses

    import torch

    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.parallel import replicated
    from deepmimic_mujoco_tpu_torch.rl import ppo as ppo_mod

    cfg, res = ppo.cfg, {}
    if batch is not None:
        one_epoch = ppo_mod.PPO(ppo.env, dataclasses.replace(cfg, epochs=1))
        res["update_1"] = dp_update(one_epoch, batch, mesh, perturb)
        res["update"] = dp_update(ppo, batch, mesh, perturb)

    # instrumentation: each gather's bytes and seconds, and the batch the
    # update is handed
    gathers, batches = [], []
    gather = ppo_mod._gather_columns

    def timed_gather(sharding, xs, dim):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = gather(sharding, xs, dim)
        torch.cuda.synchronize()
        gathers.append((dim, 4 * sum(x.numel() for x in xs),
                        time.perf_counter() - t))
        return out

    update = ppo.update
    ppo.update = lambda ts, b: batches.append(b) or update(ts, b)
    ppo_mod._gather_columns = timed_gather
    try:
        ts = dp_fresh(ppo, mesh, perturb)
        counts = dict(mesh.counts) if mesh is not None else None
        updates = ts.opt.count
        torch.cuda.synchronize()
        fs.fused_solve.launches = 0
        t = time.perf_counter()
        ts, st = ppo.train_iter(ts)
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t
        res["launches"] = fs.fused_solve.launches
    finally:
        ppo_mod._gather_columns = gather
        del ppo.update
    n = cfg.n_envs
    b = batches[0]
    res.update(
        stats={k: float(getattr(st, k)) for k in (
            "pg_loss", "v_loss", "entropy", "approx_kl", "clip_frac",
            "mean_reward", "ep_return_sum", "ep_count", "ep_len_sum",
            "contact_overflow_max")},
        params={k: v.detach().cpu().clone()
                for k, v in ts.net.state_dict().items()},
        handoff_count=int(st.handoff_count),
        updates=ts.opt.count - updates, gathers=gathers,
        first={"obs": b[0][n:2 * n].cpu(), "action": b[1][:n].cpu()})
    if mesh is None:
        res["batch"] = [x.cpu() for x in b]
    else:
        res["backend"] = mesh.backend
        res["counts"] = {k: v - counts[k] for k, v in mesh.counts.items()}
        rep = replicated(mesh)
        res["replicas_equal"] = all(rep.check(x) for x in (
            *ts.net.parameters(), *ts.opt.mu, *ts.opt.nu,
            *ts.handoff_buf, *(g.get_state() for g in ts.gens.values())))
        if save_path is not None:
            from deepmimic_mujoco_tpu_torch.rl import checkpoint

            before = dict(mesh.counts)
            torch.cuda.synchronize()
            t = time.perf_counter()
            checkpoint.save(save_path, ts)
            torch.cuda.synchronize()
            res["save"] = dict(
                seconds=time.perf_counter() - t,
                counts={k: v - before[k] for k, v in mesh.counts.items()},
                state=state_leaves(ts))
    return res


def dp_rank(mesh, batch_path, save_path):
    """A rank of the data-parallel phase's world 2 (``parallel.dryrun.
    launch``): the CLI's PPO on this rank's card, its half of the envs,
    saving the state after the iteration to ``save_path``."""
    import torch

    from deepmimic_mujoco_tpu_torch.utils.device import fp32_physics

    fp32_physics()
    batch = torch.load(batch_path, weights_only=True)
    return dp_iteration(dp_ppo(mesh.device), mesh, batch,
                        save_path=save_path)


def dp_save_round_trip(ppo, world, ranks, path, card) -> dict:
    """The state a world's ranks saved at ``path``, restored unsharded
    here into a fresh ``PPO.init``, against the state they held: their
    env rows in rank order and rank 0's replicated leaves, bit for
    bit."""
    import torch

    from deepmimic_mujoco_tpu_torch.rl import checkpoint

    local = [r["save"]["state"] for r in ranks]
    want = {k: (torch.cat([x[k] for x in local]) if k.startswith("env.")
                else v) for k, v in local[0].items()}
    got = state_leaves(checkpoint.restore(path, ppo.init(seed=DP_SEED + 1)))
    differ = sorted(k for k, v in want.items()
                    if k not in got or v.shape != got[k].shape
                    or not torch.equal(v, got[k]))
    counts = ranks[0]["save"]["counts"]
    n_env = sum(k.startswith("env.") for k in want)
    print(f"world {world} save round trip on {card}: each rank gathered "
          f"{counts['all_gather']} env-indexed leaves ({counts['bytes']} "
          f"bytes sent by rank 0), then a barrier ("
          + ", ".join(f"rank {r}: {x['save']['seconds']:.4f} s"
                      for r, x in enumerate(ranks))
          + f"); rank 0 wrote {os.path.getsize(path)} bytes; restored "
          f"unsharded here: {len(want) - len(differ)} of {len(want)} leaves "
          f"({n_env} env-indexed, {want['env.last_obs'].shape[0]} envs) "
          "equal to the ranks' gathered state bit for bit"
          + (f"; DIFFER: {differ}" if differ else ""))
    check(not differ and set(got) == set(want),
          f"world {world}: the restored state differs in {differ}")
    check(all(x["save"]["counts"]["all_gather"] == n_env
              and x["save"]["counts"]["barrier"] == 1 for x in ranks),
          f"world {world}: the save's collectives "
          f"{[x['save']['counts'] for x in ranks]}")
    return dict(leaves=len(want), env_leaves=n_env,
                gather_bytes_rank0=counts["bytes"],
                seconds=[x["save"]["seconds"] for x in ranks],
                file_bytes=os.path.getsize(path))


def dp_diffs(ref, got) -> dict:
    """``got`` against the unsharded ``ref``: losses as |d| / max(|a|, 1)
    and params as max|d| / max(max|p|, 1e-3) (tests/test_multichip.py's
    measures) for both updates on the fixed batch; the first step per
    env (each env scaled by its own max); the whole iteration's stats
    (relative) and params."""
    def losses(a, b):
        return max(float((x - y).abs()) / max(abs(float(x)), 1.0)
                   for x, y in zip(a, b))

    def params(a, b):
        return max(float((v - b[k]).abs().max())
                   / max(float(v.abs().max()), 1e-3) for k, v in a.items())

    return dict(
        update_1=(losses(ref["update_1"][0], got["update_1"][0]),
                  params(ref["update_1"][1], got["update_1"][1])),
        update=(losses(ref["update"][0], got["update"][0]),
                params(ref["update"][1], got["update"][1])),
        first_step={k: env_scaled_err(ref["first"][k], got["first"][k])
                    for k in ("obs", "action")},
        iteration=(max(abs(a - got["stats"][k]) / max(abs(a), 1e-12)
                       for k, a in ref["stats"].items()),
                   params(ref["params"], got["params"])))


def dp_held(label, d, noise, world, n_mb):
    """Print a world's divergences ``d`` beside ``noise``'s (the unsharded
    runs from params moved by 1e-7: what the arithmetic itself makes of
    a rounding) and hold the update's first epoch on the fixed batch at
    TOL_DP_LOSS / TOL_DP_PARAM (the gate) and the first step per env at
    TOL_KERNEL. The whole iteration is printed beside DP_PREDICTED."""
    import math

    pred_s, pred_p = DP_PREDICTED.get(world, DP_PREDICTED[2])
    it_s, it_p = d["iteration"]
    print(f"{label} against the unsharded runs (beside: the unsharded runs "
          f"from params x (1 + 1e-7)):")
    print(f"  the update on the unsharded rollout's batch, first epoch "
          f"({n_mb} minibatch steps): losses {d['update_1'][0]:.3e} (limit "
          f"{TOL_DP_LOSS}), params {d['update_1'][1]:.3e} scaled (limit "
          f"{TOL_DP_PARAM}); beside {noise['update_1'][0]:.3e} and "
          f"{noise['update_1'][1]:.3e}")
    print(f"  the same update, all epochs: losses {d['update'][0]:.3e}, "
          f"params {d['update'][1]:.3e} scaled; beside "
          f"{noise['update'][0]:.3e} and {noise['update'][1]:.3e}")
    print(f"  the first step per env: obs {d['first_step']['obs']:.3e}, "
          f"action {d['first_step']['action']:.3e} (limit {TOL_KERNEL})")
    print(f"  the whole iteration: stats {it_s:.3e} relative at most, "
          f"params {it_p:.3e} scaled; beside {noise['iteration'][0]:.3e} "
          f"and {noise['iteration'][1]:.3e}; predicted (PERF.md) at most "
          f"{pred_s:g} and {pred_p:g}: "
          + ("inside" if it_s <= pred_s and it_p <= pred_p
             else "OUTSIDE the prediction"))
    loss_d, param_d = d["update_1"]
    check(math.isfinite(loss_d) and loss_d < TOL_DP_LOSS,
          f"{label}: the first epoch's losses differ by {loss_d:.3e}")
    check(param_d < TOL_DP_PARAM,
          f"{label}: the first epoch's params differ by {param_d:.3e}")
    check(all(v < TOL_KERNEL for v in d["first_step"].values()),
          f"{label}: the first step differs per env: {d['first_step']}")


def data_parallel(card, dev):
    """Phase 13: the CLI's PPO on its default combined env, sharded."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist

    from deepmimic_mujoco_tpu_torch.parallel import dryrun
    from deepmimic_mujoco_tpu_torch.parallel import mesh as mesh_lib
    from deepmimic_mujoco_tpu_torch.rl import networks, ppo as ppo_mod

    ppo = dp_ppo(dev)
    cfg = ppo.cfg
    check((cfg.n_envs, cfg.horizon, cfg.minibatch_size, cfg.epochs,
           cfg.net_arch) == (2048, 64, 4096, 20, (256, 128))
          and ppo._handoff, f"not the CLI's default widths: {cfg}")
    spi = cfg.n_envs * cfg.horizon
    ref = dp_iteration(ppo)
    batch = ref.pop("batch")
    one_epoch = ppo_mod.PPO(ppo.env, dataclasses.replace(cfg, epochs=1))
    ref["update_1"] = dp_update(one_epoch, batch)
    ref["update"] = dp_update(ppo, batch)
    noise = dp_diffs(ref, dp_iteration(ppo, batch=batch, perturb=1e-7))
    out_dir = os.path.join(REPO, "build", "dp_smoke")
    os.makedirs(out_dir, exist_ok=True)
    batch_path = os.path.join(out_dir, "batch.pt")
    torch.save(batch, batch_path)
    print(f"unsharded iteration on {card}: {spi / ref['wall_s']:.1f} "
          f"env-steps/s ({ref['wall_s']:.3f} s), {ref['launches']} kernel "
          f"launches, handoff_count {ref['handoff_count']}, mean_reward "
          f"{ref['stats']['mean_reward']:.6f}, pg_loss "
          f"{ref['stats']['pg_loss']:.6f}")
    check(ref["launches"] == cfg.horizon,
          f"unsharded: {ref['launches']} launches")

    # world 1 over NCCL, in this process
    with tempfile.TemporaryDirectory() as tmp:
        mesh = mesh_lib.init_group(0, 1, f"file://{tmp}/store", device=dev)
        try:
            check(mesh.backend == "nccl", f"world 1 on {mesh.backend}")
            w1 = dp_iteration(ppo, mesh, batch)
        finally:
            dist.destroy_process_group()
    # world 2 on the one card: NCCL refuses two ranks on one device, so
    # gloo, asked for by name
    n_cards = torch.cuda.device_count()
    print("world 2 over gloo with CUDA tensors, asked for by name: "
          + ("one card, and NCCL refuses two ranks on one device; a "
             "correctness path, not a scaling number" if n_cards == 1 else
             f"its ranks on cards 0 and 1 of {n_cards}"))
    save_path = lambda w: os.path.join(out_dir, f"world{w}_state.pt")
    tw = time.perf_counter()
    w2 = dryrun.launch(dp_rank, 2, args=(batch_path, save_path(2)),
                       device=dev, backend="gloo")
    w2_s = time.perf_counter() - tw
    worlds = [(1, [w1]), (2, w2)]
    if n_cards > 1:
        # every card a rank of its own, over NCCL
        worlds.append((n_cards, dryrun.launch(
            dp_rank, n_cards, args=(batch_path, save_path(n_cards)),
            device=dev)))
    # the sharded save (rl/checkpoint.py): the state after each spawned
    # world's iteration, restored unsharded here
    saves = {f"world{w}": dp_save_round_trip(ppo, w, ranks, save_path(w),
                                             card)
             for w, ranks in worlds[1:]}
    held = {}
    for world, ranks in worlds:
        for r, got in enumerate(ranks):
            label = f"world {world} rank {r}"
            traj = [g for g in got["gathers"] if g[0] == 1]
            rows = [g for g in got["gathers"] if g[0] == 0]
            want_ar = 2 + cfg.epochs + got["updates"]
            print(f"{label} ({got['backend']}) on {card}: "
                  f"{spi / got['wall_s']:.1f} env-steps/s for the world's "
                  f"{spi} steps ({got['wall_s']:.3f} s; update alone on "
                  f"the fixed batch {got['update'][2]:.3f} s); "
                  f"{got['launches']} kernel launches; collectives "
                  f"{got['counts']['all_reduce']} all_reduce (expected "
                  f"{want_ar}: 2 stats, {cfg.epochs} losses, "
                  f"{got['updates']} gradient), "
                  f"{got['counts']['all_gather']} all_gather, "
                  f"{got['counts']['bytes']} bytes sent; the trajectory "
                  f"gather {traj[0][1]} bytes a rank in {traj[0][2]:.4f} "
                  f"s, the handoff rows {len(rows)} gathers of "
                  f"{rows[0][1]} bytes in {sum(g[2] for g in rows):.4f} s; "
                  f"handoff_count {got['handoff_count']}, replicas equal "
                  f"{got['replicas_equal']}")
            check(got["launches"] == cfg.horizon,
                  f"{label}: {got['launches']} launches in an iteration")
            check(got["counts"]["all_reduce"] == want_ar
                  and got["counts"]["all_gather"] == cfg.horizon + 1,
                  f"{label}: collectives {got['counts']}")
            check(got["replicas_equal"], f"{label}: the replicas differ")
            check(got["handoff_count"] == ref["handoff_count"],
                  f"{label}: handoff_count {got['handoff_count']}")
            held[(world, r)] = dp_diffs(ref, got)
            dp_held(label, held[(world, r)], noise, world,
                    ppo.n_minibatches)
    for world, ranks in worlds[1:]:
        check(all(torch.equal(a, got["params"][k]) for got in ranks[1:]
                  for k, a in ranks[0]["params"].items()),
              f"world {world}: the ranks' params differ")
    print(f"world 2 launch (spawn, env build, both runs): {w2_s:.2f} s")

    # the kernel on rank 0's first-step inputs (B = n_envs / 2)
    n = cfg.n_envs // 2
    with torch.no_grad():
        ts = ppo.init(seed=DP_SEED)
        state = type(ts.env_states)(*[x[:n] for x in ts.env_states])
        obs = ts.last_obs[:n]
        mean, log_std, _ = ts.net(obs)
        # the global batch's draw, as every rank draws it
        eps = ppo.draw_noise(ts, mean.new_empty(cfg.n_envs,
                                                mean.shape[1]))[:n]
        action = networks.env_action(ts.net, obs,
                                     mean + torch.exp(log_std) * eps)
        args, kw = capture_parts(ppo.env, state, action)
    check((kw["K"], kw["L"], args[0].shape[0]) == (24, 37, n),
          f"rank 0's solve: K={kw['K']}, L={kw['L']}, B={args[0].shape[0]}")
    dp_k = kernel_on_main_path(f"data-parallel rank 0 (B {n})", card, args,
                               kw)
    return dict(launches=w2[0]["launches"],
                launches_per_rank={f"world{w}": [g["launches"] for g in rs]
                                   for w, rs in worlds},
                **dp_k, held={f"world{w}_rank{r}": v
                              for (w, r), v in held.items()},
                perturbed_1e7=noise,
                env_steps_per_s={"unsharded": spi / ref["wall_s"], **{
                    f"world{w}_{rs[0]['backend']}":
                        spi / max(g["wall_s"] for g in rs)
                    for w, rs in worlds}},
                all_reduce_per_iteration=w2[0]["counts"]["all_reduce"],
                save_round_trip=saves,
                trajectory_gather=[g for g in w2[0]["gathers"]
                                   if g[0] == 1][0][1:])


def render_modules():
    """{module: present} of what the render paths draw with: cv2
    (overlay text, mp4) and matplotlib (the dashboard's panel and plots,
    check_debug_log's plots). A part that needs an absent one is left
    out, and the run says so."""
    from deepmimic_mujoco_tpu_torch.rl.train import (
        RENDER_MODULES, missing_render_modules,
    )

    missing = missing_render_modules()
    return {m: m not in missing for m in RENDER_MODULES}


def video_frames(path):
    """Frames cv2 decodes from the mp4 at ``path``."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def play_combined_run(device="cuda"):
    """tools/play_combined.main with the combined gate actor and falls
    injected, and --video where cv2 is present; returns its reward and
    cycles, the steps it ran, the physics steps among them, whether the
    fall -> to_getup -> getup path ran, and the video's frames."""
    import contextlib
    import io

    from deepmimic_mujoco_tpu_torch.tools import play_combined

    video = os.path.join(RENDER_DIR, "play_combined.mp4")
    argv = ["--checkpoint", os.path.join(
        REPO, "deepmimic_mujoco_tpu_torch", "data", COMBINED_GATE[0]),
        *PLAY_ARGV, "--device", device]
    if render_modules()["cv2"]:
        os.makedirs(RENDER_DIR, exist_ok=True)
        argv += ["--video", video]
    print("python -m deepmimic_mujoco_tpu_torch.tools.play_combined "
          + " ".join(os.path.relpath(a, REPO) if os.path.isabs(a) else a
                     for a in argv))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        ep_rew, cycles = play_combined.main(argv)
    text = log.getvalue()
    for line in text.splitlines():
        print("  " + line)
    m = re.search(r"done at (\d+)", text)
    steps = int(m.group(1)) + 1 if m else int(PLAY_ARGV[1])
    n_inject = text.count("injecting fall")
    forced = min(int(PLAY_ARGV[3]), steps) + n_inject
    path_ran = (n_inject >= 1 and "changing to motion: to_getup" in text
                and "changing to motion: getup"
                in text.split("injecting fall")[1])
    frames = video_frames(video) if "--video" in argv else None
    if frames is not None:
        check(frames == -(-steps // 4),
              f"play_combined --video: {frames} frames for {steps} steps")
    return dict(reward=ep_rew, cycles=cycles, steps=steps,
                injected=n_inject, physics_steps=steps - forced,
                path_ran=bool(path_ran), video_frames=frames)


def play_extracted_run(device="cuda"):
    """tools/play.main on the extracted G1 run artifact (golden-vector
    test first, then one episode through GymDPEnv with the reward gate);
    returns its reward, the steps it ran and whether the golden test
    passed. Its output is printed whether or not the gate holds."""
    import contextlib
    import io

    from deepmimic_mujoco_tpu_torch.tools import play

    argv = [*PLAY_EXTRACTED_ARGV, "--device", device]
    print("python -m deepmimic_mujoco_tpu_torch.tools.play "
          + " ".join(os.path.relpath(a, REPO) if os.path.isabs(a) else a
                     for a in argv))
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            ep_rew = play.main(argv)
    finally:
        for line in log.getvalue().splitlines():
            print("  " + line)
    text = log.getvalue()
    return dict(reward=ep_rew,
                steps=int(re.search(r"over (\d+) steps", text).group(1)),
                golden="golden-vector test OK" in text)


def writable_asset_root(root):
    """An asset root for retarget's output: symlinks to the vendored
    root, with the G1 walk clip (the file retarget writes) left out."""
    import shutil

    from deepmimic_mujoco_tpu_torch.models import assets

    real = assets.asset_root()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "motions"))
    os.symlink(os.path.join(real, "humanoid_deepmimic"),
               os.path.join(root, "humanoid_deepmimic"))
    for f in os.listdir(os.path.join(real, "motions")):
        if f != "unitree_g1_walk.txt":
            os.symlink(os.path.join(real, "motions", f),
                       os.path.join(root, "motions", f))
    return root


def render_job(device="cuda"):
    """The render paths on the card, in a process of its own beside the
    replays: the ray tracer built with g++ from the checkout; render_state
    of humanoid3d and G1 with FK on the card against FK on the CPU path,
    and its ms per frame; the viewer's frames from the clip and from the
    h3d walk gate actor; the eval dashboard of that actor; play --video of
    the extracted G1 run artifact; check_debug_log of a dump GymDPEnv
    wrote on the card; retarget of walk into a writable asset root and
    validate_clip. Kernel launches are counted per path (zeroed just
    before it). Parts that need an absent cv2 or matplotlib are left
    out, and the result says which. Returns the numbers the parent
    prints."""
    import contextlib
    import io
    import shutil
    import statistics
    import types

    import numpy as np
    import torch

    from deepmimic_mujoco_tpu_torch import native
    from deepmimic_mujoco_tpu_torch.envs import DPEnv
    from deepmimic_mujoco_tpu_torch.envs.gym_wrapper import GymDPEnv
    from deepmimic_mujoco_tpu_torch.mocap import load_clip
    from deepmimic_mujoco_tpu_torch.models import assets, load_model
    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.rl import checkpoint
    from deepmimic_mujoco_tpu_torch.rl import eval as rl_eval
    from deepmimic_mujoco_tpu_torch.rl.convert import actor_from_npz
    from deepmimic_mujoco_tpu_torch.tools import (
        check_debug_log, play, retarget,
    )
    from deepmimic_mujoco_tpu_torch.tools.render import render_state
    from deepmimic_mujoco_tpu_torch.tools.view import (
        Viewer, mocap_source, policy_source,
    )

    has = render_modules()
    absent = [m for m, ok in has.items() if not ok]
    shutil.rmtree(RENDER_DIR, ignore_errors=True)
    os.makedirs(RENDER_DIR)
    data = os.path.join(REPO, "deepmimic_mujoco_tpu_torch", "data")
    res = {"absent": absent, "threads": os.environ.get("OMP_NUM_THREADS")}

    # the ray tracer, built from the checkout's source
    res["gxx_s"] = native.build(force=True)
    lib = native.rasterizer_lib()
    want = os.path.join(REPO, "build", "torch_kernels", "librasterizer.so")
    check(lib is not None and os.path.realpath(lib._name)
          == os.path.realpath(want), f"ray tracer library {lib}")
    print(f"g++ {' '.join(native.GXX_FLAGS)} "
          f"{os.path.relpath(native.SOURCE, REPO)} -> "
          f"{os.path.relpath(lib._name, REPO)}: {res['gxx_s']:.2f} s")

    # render_state, FK on the card against FK on the CPU path
    res["ms_per_frame"], res["pixel_share"] = {}, {}
    for robot in ("humanoid3d", "unitree_g1"):
        m = load_model(assets.xml_path(robot))
        q = (m.key_qpos[0] if robot == "unitree_g1" else load_clip(
            assets.mocap_path(robot, "walk"), m).qpos[10])
        card = render_state(m, q, width=320, height=240, device=device)
        cpu = render_state(m, q, width=320, height=240, device="cpu")
        share = float((card != cpu).any(-1).mean())
        print(f"render_state {robot} 320x240, FK on the card vs the CPU "
              f"path: {100 * share:.4f}% of the pixels differ, frame std "
              f"{card.std():.2f}")
        check(share <= TOL_PIXELS and card.std() > 20,
              f"render_state {robot}: share {share}, std {card.std()}")
        res["pixel_share"][robot] = share
        for w, h in ((320, 240), (480, 480)):
            ts = []
            for _ in range(5):
                t = time.perf_counter()
                render_state(m, q, width=w, height=h, device=device)
                ts.append((time.perf_counter() - t) * 1e3)
            res["ms_per_frame"][f"{robot} {w}x{h}"] = statistics.median(ts)
    print(f"render_state ms per frame (median of 5; FK on the card, the "
          f"ray tracer on {res['threads']} host thread(s)): " + ", ".join(
              f"{k} {v:.2f}" for k, v in res["ms_per_frame"].items()))

    # the viewer: frames from the clip, then from the gate actor's policy
    env = DPEnv(motion="walk", robot="humanoid3d", device=device)
    net = actor_from_npz(os.path.join(data, "h3d_walk_gate_actor.npz"),
                         device=device,
                         generator=torch.Generator(device).manual_seed(0))
    params = checkpoint.save_params(
        os.path.join(RENDER_DIR, "h3d_walk_gate.pt"), net)
    overlay = None if has["cv2"] else (lambda i: "")
    views = {}
    for name, src in (("mocap", mocap_source(env)[0]),
                      ("policy", policy_source(env, params))):
        v = Viewer(env.model, src, overlay, width=320, height=240,
                   device=device)
        fs.fused_solve.launches = 0
        frames = [v.step_once() for _ in range(VIEW_FRAMES)]
        views[name] = fs.fused_solve.launches
        check(all((a != b).any() for a, b in zip(frames, frames[1:])),
              f"viewer ({name}): consecutive frames are equal")
    print(f"viewer: {VIEW_FRAMES} frames from the clip ({views['mocap']} "
          f"kernel launches), {VIEW_FRAMES} from the gate actor's policy "
          f"({views['policy']} launches)")
    check(views == {"mocap": 0, "policy": VIEW_FRAMES},
          f"viewer launches {views}")
    res["view_policy_launches"] = views["policy"]

    # the eval dashboard of the gate actor
    dash = has["cv2"] and has["matplotlib"]
    drawn = []
    frames_fn = rl_eval.dashboard_frames

    def timed_frames(*a, **k):
        t = time.perf_counter()
        out = frames_fn(*a, **k)
        drawn.append((len(out), time.perf_counter() - t))
        return out

    rl_eval.dashboard_frames = timed_frames
    fs.fused_solve.launches = 0
    try:
        with torch.no_grad():
            tr = rl_eval.eval_dashboard_rollout(
                types.SimpleNamespace(env=env), net, DASHBOARD_STEPS,
                "render_smoke", out_dir=RENDER_DIR, render=dash,
                max_steps=DASHBOARD_STEPS)
    finally:
        rl_eval.dashboard_frames = frames_fn
    res["dashboard_launches"] = fs.fused_solve.launches
    res["dashboard_len"] = tr["ep_len"]
    vdir = os.path.join(RENDER_DIR, "render_smoke_videos")
    check(os.path.exists(os.path.join(vdir, "render_smoke_best.pt"))
          and os.path.exists(os.path.join(vdir, "log.csv")),
          "the dashboard wrote no best params or log")
    check(res["dashboard_launches"] == tr["ep_len"],
          f"dashboard: {res['dashboard_launches']} launches in "
          f"{tr['ep_len']} steps")
    res["dashboard_ms_per_frame"] = None
    if dash:
        n, secs = drawn[0]
        res["dashboard_ms_per_frame"] = secs * 1e3 / n
        got = video_frames(os.path.join(
            vdir, f"global_step_{DASHBOARD_STEPS}.mp4"))
        check(got == n and n >= 1, f"dashboard video: {got} of {n} frames")
        check(all(os.path.getsize(os.path.join(vdir, f)) > 0
                  for f in ("rew_plot.png", "len_plot.png")),
              "the dashboard's plots")
    print(f"eval dashboard of the gate actor: {tr['ep_len']} steps, reward "
          f"{tr['ep_rew']:.2f}, {res['dashboard_launches']} kernel launches; "
          + (f"{drawn[0][0]} frames at {res['dashboard_ms_per_frame']:.1f} "
             "ms each (render_state 320x240 + the 2x2 panel)" if dash else
             f"video and plots left out ({', '.join(absent)} absent)"))

    # play --video of the extracted G1 run artifact
    video = os.path.join(RENDER_DIR, "play.mp4")
    argv = ["--checkpoint", os.path.join(data, "run_extracted.npz"),
            "--motion", "run", "--robot", "unitree_g1", "--max-steps",
            str(PLAY_VIDEO_STEPS), "--device", device]
    if has["cv2"]:
        argv += ["--video", video]
    log = io.StringIO()
    fs.fused_solve.launches = 0
    with contextlib.redirect_stdout(log):
        ep_rew = play.main(argv)
    res["play_launches"] = fs.fused_solve.launches
    steps = int(re.search(r"over (\d+) steps", log.getvalue()).group(1))
    res["play_steps"], res["play_reward"] = steps, ep_rew
    res["play_frames"] = video_frames(video) if has["cv2"] else None
    shown = " ".join(os.path.relpath(a, REPO) if os.path.isabs(a) else a
                     for a in argv)
    print(f"python -m deepmimic_mujoco_tpu_torch.tools.play {shown}: "
          f"reward {ep_rew:.2f} over {steps} steps, {res['play_launches']} "
          f"kernel launches, video frames {res['play_frames']}")
    check(res["play_launches"] == steps, "play --video launches")
    check(not has["cv2"] or res["play_frames"] == -(-steps // 2),
          f"play --video: {res['play_frames']} frames for {steps} steps")

    # check_debug_log of a dump GymDPEnv writes on the card
    g = GymDPEnv(motion="walk", robot="humanoid3d", device=device,
                 crash_dump_dir=RENDER_DIR)
    g.reset()
    g.reset_model(idx_init=3)
    zero = np.zeros(g.env.action_size)
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(3):
            g.step(zero)
        _, _, done, info = g.step(zero, force_state=(
            g.mocap.qpos[6], np.full(g.model.nv, 1e6)))
    check(done and info.get("done_reason") == "obs_out_of_bounds",
          f"no divergence dump: {info}")
    (dump,) = [os.path.join(RENDER_DIR, f) for f in os.listdir(RENDER_DIR)
               if f.startswith("deepmimic_episode_")]
    video = os.path.join(RENDER_DIR, "debug_log.mp4")
    if has["matplotlib"]:
        check_debug_log.main([dump, "--video", video, "--plot", os.path.join(
            RENDER_DIR, "debug_log.png"), "--device", device])
    elif has["cv2"]:
        check_debug_log.dump_video(check_debug_log.load_dump(dump), video,
                                   device)
    if has["cv2"]:
        res["debug_log_frames"] = video_frames(video)
        check(res["debug_log_frames"] == 2,
              f"check_debug_log video: {res['debug_log_frames']} frames")

    # retarget walk into a writable asset root, then validate_clip
    root = writable_asset_root(os.path.join(REPO, "build", "retarget_smoke"))
    before = os.environ.get("DM_TPU_ASSET_ROOT")
    os.environ["DM_TPU_ASSET_ROOT"] = root
    try:
        t = time.perf_counter()
        out = retarget.retarget_motion_humanoid_to_unitree_g1(
            "walk", validate=False)
        res["retarget_s"] = time.perf_counter() - t
        check(os.path.dirname(out) == os.path.join(root, "motions"),
              f"retarget wrote {out}")
        try:
            retarget.retarget_motion_humanoid_to_unitree_g1(
                "walk", validate=False)
            check(False, "retarget overwrote its clip")
        except FileExistsError:
            pass
        fs.fused_solve.launches = 0
        rews = retarget.validate_clip("walk", device=device)
        res["validate_launches"] = fs.fused_solve.launches
    finally:
        if before is None:
            del os.environ["DM_TPU_ASSET_ROOT"]
        else:
            os.environ["DM_TPU_ASSET_ROOT"] = before
    res["validate_mean"], res["validate_steps"] = float(rews.mean()), len(rews)
    print(f"retarget walk -> {os.path.relpath(out, REPO)} in "
          f"{res['retarget_s']:.2f} s; validate_clip on the card: mean "
          f"{rews.mean():.4f}, min {rews.min():.4f} over {len(rews)} "
          f"force-state steps, {res['validate_launches']} kernel launches "
          "(no dynamics run)")
    check(rews.mean() > 0.9, f"validate_clip mean {rews.mean()}")
    check(res["validate_launches"] == 0, "validate_clip launched the kernel")
    return res


def run_replays(card, names, timeout):
    """Every named replay in a process of its own, all started together;
    prints each one's lines in order and returns {name: result}. Every
    process is stopped before this returns."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    try:
        for name in names:
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--replay",
                 name], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env)
        deadline = time.monotonic() + timeout
        results = {}
        for name, proc in procs.items():
            out, _ = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            lines = out.splitlines()
            sec = [json.loads(line.split(" ", 1)[1]).get("seconds")
                   for line in lines if line.startswith("REPLAY_RESULT ")]
            print(f"-- replay {name} on {card} (exit {proc.returncode}"
                  + (f", {sec[0]:.2f} s" if sec else "") + "):")
            for line in lines:
                if not line.startswith("REPLAY_RESULT "):
                    print("  " + line)
            res = [json.loads(line.split(" ", 1)[1]) for line in lines
                   if line.startswith("REPLAY_RESULT ")]
            check(proc.returncode == 0 and res,
                  f"replay {name} failed (exit {proc.returncode})")
            results[name] = res[0]
        return results
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def profiled_calls(fn, reps):
    """(device kernels, device ms, wall ms) per call of fn, under
    torch.profiler after three warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tw) * 1e3 / reps
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in ev) / reps,
            sum(getattr(e, "self_device_time_total", 0.0)
                for e in ev) / reps / 1e3, wall)


def wall_ms(fn, reps):
    """Wall ms per call of fn, unprofiled, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - tw) * 1e3 / reps


def update_step_profile(ppo, ts, card):
    """The update's minibatch step (loss, backward, gradient clip, Adam)
    on a minibatch of the CLI's size, under torch.profiler; then the
    optimizer step alone, the port's optax-arithmetic Adam beside
    torch.optim.Adam(fused=True) on copies of the same params and
    gradients, each over the same number of steps."""
    import torch

    from deepmimic_mujoco_tpu_torch.rl import networks

    cfg = ppo.cfg
    net, dev = ts.net, ts.last_obs.device
    params = list(net.parameters())
    g = torch.Generator(device=dev).manual_seed(6)
    n = cfg.minibatch_size
    with torch.no_grad():
        obs = ts.last_obs[torch.randint(0, ts.last_obs.shape[0], (n,),
                                        generator=g, device=dev)]
        mean, log_std, value = net(obs)
        action = mean + torch.exp(log_std) * torch.randn(
            mean.shape, generator=g, device=dev)
        logp = networks.gaussian_logp(action, mean, log_std)
        adv = torch.randn(n, generator=g, device=dev)
        mb = [obs, action, logp, value, adv, value + adv]

    k, d_ms, w_ms = profiled_calls(
        lambda: ppo.minibatch_step(ts, mb, params), 20)
    mb_ms = wall_ms(lambda: ppo.minibatch_step(ts, mb, params), 50)
    print(f"update minibatch step ({n} samples, net {cfg.net_arch}) on "
          f"{card}: {k:.0f} device kernels, device busy {d_ms:.4f} ms of "
          f"{w_ms:.4f} ms wall ({100 * d_ms / w_ms:.1f}%) under the "
          f"profiler; {mb_ms:.4f} ms per step unprofiled")
    # the optimizer step alone, on copies holding the last gradients
    lr = ppo.lr_at(ts.opt.count, ts.lr_scale)
    mine = [p.detach().clone() for p in params]
    theirs = [p.detach().clone() for p in params]
    for a, b, p in zip(mine, theirs, params):
        a.grad, b.grad = p.grad.clone(), p.grad.clone()
    port_adam = type(ts.opt)(mine, eps=cfg.adam_eps)
    torch_adam = torch.optim.Adam(theirs, lr=lr, eps=cfg.adam_eps,
                                  fused=True)
    rows = []
    for name, step in (("port Adam (optax arithmetic)",
                        lambda: port_adam.step(lr)),
                       ("torch.optim.Adam(fused=True)", torch_adam.step)):
        k, d_ms, _ = profiled_calls(step, 20)
        rows.append((name, k, d_ms, wall_ms(step, 200)))
    print(f"optimizer step over {len(params)} params on {card}: " + "; ".join(
        f"{name} {k:.0f} device kernels, device {d_ms:.4f} ms, "
        f"{w_ms:.4f} ms wall" for name, k, d_ms, w_ms in rows))
    return mb_ms


def ppo_training(card, dev, argv, out_name, env=None,
                 widths=(2048, 64, 4096, 20), first=None):
    """Phases 5, 8 and 15: the CLI's main() on ``argv`` for two
    iterations at ``widths`` (n_envs, horizon, minibatch, epochs; net
    (256, 128)). With ``env``, then the checkpoint round trip and the
    update profile. With ``first`` (a dict), the env, the net's params
    just before the first iteration and the kernel's inputs of its first
    step in the training thread are stored in it. Returns {"launches":
    the kernel launches of each iteration in the training thread, read
    from the kernel's per-thread count (the CLI's evaluator thread
    launches it too, and keeps its own count), "eval_launches": the
    evaluator's, "handoff": the handoff buffer's row count after each
    iteration (None without a buffer), "iters": the iterations' metrics
    rows, "seconds": (rollout, update, iteration) of each}."""
    import glob
    import math
    import threading

    import torch

    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.physics import solver
    from deepmimic_mujoco_tpu_torch.rl import checkpoint, ppo as ppo_mod
    from deepmimic_mujoco_tpu_torch.rl.train import main as train_main

    out_dir = os.path.join(REPO, "build", out_name)
    os.makedirs(out_dir, exist_ok=True)
    by_thread = fs.fused_solve.launches_by_thread
    me = threading.get_ident()
    # instrumentation: wall time of each iteration's parts; the training
    # thread's launch count is zeroed just before each iteration and
    # read just after it
    times = []
    parts_entry = solver.fused_solve_parts

    def record_first_solve(*args, **kw):
        # the first solve of the first iteration in the training thread
        if ("solve" not in first and "params" in first
                and threading.get_ident() == me):
            first["solve"] = ([a.clone() for a in args], dict(kw))
        return parts_entry(*args, **kw)

    def timed(name, fn):
        def wrapper(self, ts, *a, **k):
            torch.cuda.synchronize()
            if name == "train_iter":
                by_thread[me] = 0
                if first is not None and "params" not in first:
                    first["env"] = self.env
                    first["params"] = {k: v.detach().clone() for k, v in
                                       ts.net.state_dict().items()}
            t = time.perf_counter()
            out = fn(self, ts, *a, **k)
            torch.cuda.synchronize()
            times.append((name, time.perf_counter() - t,
                          by_thread.get(me, 0)))
            return out
        return wrapper

    originals = {n: getattr(ppo_mod.PPO, n)
                 for n in ("rollout", "update", "train_iter")}
    for n, fn in originals.items():
        setattr(ppo_mod.PPO, n, timed(n, fn))
    if first is not None:
        solver.fused_solve_parts = record_first_solve
    try:
        argv = [*argv, "--out", out_dir]
        print("python -m deepmimic_mujoco_tpu_torch.rl.train "
              + " ".join(repr(a) if " " in a else a for a in argv))
        before = dict(by_thread)
        ts = train_main(argv)
        solver.fused_solve_parts = parts_entry
        cli_times = list(times)
        iter_launches = [t[2] for t in cli_times if t[0] == "train_iter"]
        # main() has stopped its evaluator; its thread's launches
        eval_launches = sum(n - before.get(t, 0) for t, n in
                            by_thread.items() if t != me)
        rows = [json.loads(line) for line in open(sorted(glob.glob(
            os.path.join(out_dir, "*_metrics.jsonl")))[-1])]
        cfg = ppo_mod.PPOConfig(**{k: rows[0]["config"][v] for k, v in (
            ("n_envs", "n_envs"), ("horizon", "horizon"),
            ("minibatch_size", "minibatch_size"), ("epochs", "epochs"),
            ("lr", "learning_rate"), ("total_timesteps",
                                      "total_timesteps"))})
        check((cfg.n_envs, cfg.horizon, cfg.minibatch_size, cfg.epochs)
              == tuple(widths) and tuple(rows[0]["config"]["arch"])
              == (256, 128), f"not the widths {widths}: {cfg}")
        iters = [r for r in rows if "pg_loss" in r]
        check(len(iters) == 2, f"{len(iters)} iterations logged, not 2")
        per_it = [t for t in cli_times if t[0] == "train_iter"]
        roll = [t for t in cli_times if t[0] == "rollout"]
        upd = [t for t in cli_times if t[0] == "update"]
        spi = cfg.n_envs * cfg.horizon
        for i, r in enumerate(iters):
            print(f"PPO iteration {i + 1} on {card}: "
                  f"{spi / per_it[i][1]:.1f} env-steps/s ({per_it[i][1]:.3f} "
                  f"s: rollout {roll[i][1]:.3f} s, update {upd[i][1]:.3f} s "
                  f"for {cfg.epochs} x {spi // cfg.minibatch_size} "
                  f"minibatches); pg_loss {r['pg_loss']:.6f} v_loss "
                  f"{r['v_loss']:.6f} entropy {r['entropy']:.4f} approx_kl "
                  f"{r['approx_kl']:.6f} clip_frac {r['clip_frac']:.4f} "
                  f"mean_reward {r['mean_reward']:.4f} "
                  f"contact_overflow_max {r['contact_overflow_max']}"
                  + (f" handoff_count {r['handoff_count']}"
                     if "handoff_count" in r else "")
                  + f"; kernel launches in the training thread "
                  f"{iter_launches[i]}")
            check(all(math.isfinite(r[k]) for k in (
                "pg_loss", "v_loss", "entropy", "approx_kl")),
                f"non-finite losses in iteration {i + 1}: {r}")
        check(iter_launches == [cfg.horizon] * len(iters),
              f"kernel launches per iteration: {iter_launches}")
        evals = [r for r in rows if "eval_episode_reward" in r]
        eval_steps = sum(r["eval_episode_length"] for r in evals)
        print(f"evaluator thread: {len(evals)} eval(s): "
              + ", ".join(f"len {r['eval_episode_length']} reward "
                          f"{r['eval_episode_reward']:.2f}" for r in evals)
              + f"; {eval_launches} kernel launches in {eval_steps} steps")
        check(evals, "the evaluator finished no evaluation")
        check(eval_launches == eval_steps,
              f"{eval_launches} evaluator launches in {eval_steps} steps")
        handoff = [r.get("handoff_count") for r in iters]
        result = dict(launches=iter_launches, eval_launches=eval_launches,
                      handoff=handoff, iters=iters, seconds=[
                          (r[1], u[1], i[1])
                          for r, u, i in zip(roll, upd, per_it)])
        if env is None:
            return result
        ppo = ppo_mod.PPO(env, cfg)
        init = ppo.make_net(torch.Generator().manual_seed(0)).state_dict()
        moved = max(float((v.to(dev) - ts.net.state_dict()[k]).abs().max())
                    for k, v in init.items())
        print(f"params moved by up to {moved:.4e} from their initial values")
        check(moved > 0, "the params did not move")

        # resume equals continue: save, run one more iteration; restore
        # into a fresh state and run it again
        path = checkpoint.save(os.path.join(out_dir, "round_trip.pt"), ts)
        times.clear()
        ts, cont = ppo.train_iter(ts)
        back = checkpoint.restore(path, ppo.init(seed=1))
        back, res = ppo.train_iter(back)
        errs = {k: abs(float(getattr(cont, k)) - float(getattr(res, k)))
                / max(abs(float(getattr(cont, k))), 1e-12)
                for k in ("pg_loss", "v_loss", "entropy", "approx_kl",
                          "clip_frac", "mean_reward")}
        print("iteration 3 resumed from the checkpoint vs continued: "
              "relative diff " + " ".join(f"{k}={v:.2e}"
                                          for k, v in errs.items())
              + f"; pg_loss {float(cont.pg_loss):.6f} vs "
                f"{float(res.pg_loss):.6f}")
        check(all(v < TOL_RESUME for v in errs.values()),
              f"resumed iteration differs from the continued one: {errs}")
        launches = [t[2] for t in times if t[0] == "train_iter"]
        check(launches == [cfg.horizon] * 2,
              f"launches per resumed/continued iteration: {launches}")
    finally:
        solver.fused_solve_parts = parts_entry
        for n, fn in originals.items():
            setattr(ppo_mod.PPO, n, fn)
    update_step_profile(ppo, ts, card)
    return result


def finetune_recipe(card, dev, name):
    """Phase 15: recipe ``name`` of RECIPES through the CLI's main() for
    two iterations (``ppo_training``): the net before the first update
    against the exported file, the engine's options, the kernel held and
    timed on the first step's inputs, the iterations beside the JAX
    package's log. Returns the numbers of the kernels line."""
    import math

    import torch

    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.physics.collision import (
        build_pair_tables,
    )
    from deepmimic_mujoco_tpu_torch.rl import checkpoint

    flags, params_file, log_std, jax_log = RECIPES[name]
    path = os.path.join(REPO, "deepmimic_mujoco_tpu_torch", "data",
                        params_file)
    argv = [f"chip smoke {name}", *flags, *RECIPE_ARGV, "--init-params",
            path, "--reset-log-std", str(log_std)]
    first = {}
    run = ppo_training(card, dev, argv, f"finetune_{name}_smoke",
                       widths=RECIPE_WIDTHS, first=first)
    # before the first update: the export, bit for bit, log_std reset
    want, got = checkpoint.restore_params(path), first["params"]
    moved = sorted(k for k, v in want.items() if k != "log_std"
                   and not torch.equal(v, got[k].cpu()))
    reset = torch.equal(got["log_std"].cpu(),
                        torch.full_like(want["log_std"], log_std))
    print(f"{name}: the net before the first update against "
          f"data/{params_file}: {len(want) - 1 - len(moved)} of "
          f"{len(want) - 1} tensors equal bit for bit, log_std "
          + (f"reset to {log_std}" if reset else "NOT reset"))
    check(not moved and reset, f"{name}: the warm start differs: {moved}, "
          f"log_std reset {reset}")
    env = first["env"]
    eng = env.engine
    args, kw = first["solve"]
    B, nv = args[0].shape[:2]
    n = 3 * kw["K"] + kw["L"]
    plan = fs.launch_plan(nv, n, kw["K"])
    lam0_zero = bool((args[-1] == 0).all())
    tables = [len(g.g1) for g in eng.tables]
    one_cap = tables == [len(g.g1) for g in build_pair_tables(env.model, 1)]
    print(f"{name}: engine warm_start_lam {eng.warm_start_lam}, pair "
          f"tables {tables} ({'one subcapsule' if one_cap else 'not one'} "
          f"per mesh link); the first step's solve: B {B}, nv {nv}, K "
          f"{kw['K']}, L {kw['L']}, n {n}, plan {plan.label}, lam0 "
          + ("zero" if lam0_zero else
             f"nonzero (max |lam0| {float(args[-1].abs().max()):.4g})"))
    check((B, kw["K"], kw["L"]) == (RECIPE_WIDTHS[0], 24, 37),
          f"{name}: the first solve at B {B}, K {kw['K']}, L {kw['L']}")
    if name == "f2":
        check(not eng.warm_start_lam and one_cap and lam0_zero,
              f"{name}: not the F2 engine (warm start "
              f"{eng.warm_start_lam}, tables {tables}, lam0 zero "
              f"{lam0_zero})")
    k = kernel_on_main_path(f"{name} recipe", card, args, kw)
    sps = []
    for i, (r, (rol, upd, it), (j_rew, j_len, j_kl)) in enumerate(zip(
            run["iters"], run["seconds"], jax_log)):
        sps.append(RECIPE_ITER / it)
        print(f"{name} iteration {i} on {card}: {sps[-1]:.1f} env-steps/s "
              f"(rollout {rol:.3f} s, update {upd:.3f} s); r/step "
              f"{r['mean_reward']:.3f} ep_len {r['ep_length']:.1f} kl "
              f"{r['approx_kl']:.4f} clip_frac {r['clip_frac']:.4f}; the "
              f"JAX package's log of the recipe: r/step {j_rew} ep_len "
              f"{j_len} kl {j_kl} (other random streams: printed, not "
              "held)")
        check(all(math.isfinite(r[x]) for x in (
            "pg_loss", "v_loss", "entropy", "approx_kl", "clip_frac")),
            f"{name}: non-finite statistics in iteration {i}: {r}")
    if name == "r5b":
        check(run["handoff"][-1] is not None and run["handoff"][-1] > 0,
              f"r5b: handoff_count after the iterations {run['handoff']}")
    return dict(launches=sum(run["launches"]),
                launches_per_iteration=run["launches"],
                evaluator_launches=run["eval_launches"], **k,
                plan=f"{plan.tr}x{plan.tc}", L=kw["L"], lam0_zero=lam0_zero,
                env_steps_per_s=sps, handoff_count=run["handoff"],
                stats=[{x: r[x] for x in ("mean_reward", "ep_length",
                                          "approx_kl", "clip_frac")}
                       for r in run["iters"]])


def sac_training(card):
    """Phase 10: the SAC CLI's main() at its default widths for two
    iterations, with an evaluation after each. Per iteration: the
    training thread's kernel launches (its count zeroed just before the
    iteration and read just after), env-steps/s with the collect and the
    updates apart, losses and alpha; then one update step under
    torch.profiler. Returns (launches per iteration, evaluator launches,
    the numbers for the kernels line)."""
    import glob
    import math
    import threading

    import torch

    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.rl import sac as sac_mod, sac_train

    out_dir = os.path.join(REPO, "build", "sac_smoke")
    os.makedirs(out_dir, exist_ok=True)
    by_thread = fs.fused_solve.launches_by_thread
    me = threading.get_ident()
    times, trainers, evals = [], [], []
    collect, train_iter = sac_mod.SAC.collect, sac_mod.SAC.train_iter
    eval_episode = sac_train.eval_episode

    def timed_collect(self, st):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = collect(self, st)
        torch.cuda.synchronize()
        times.append(("collect", time.perf_counter() - t))
        return out

    def counted_iter(self, st):
        trainers.append(self)
        torch.cuda.synchronize()
        by_thread[me] = 0
        t = time.perf_counter()
        out = train_iter(self, st)
        torch.cuda.synchronize()
        times.append(("train_iter", time.perf_counter() - t,
                      by_thread.get(me, 0)))
        return out

    def counted_eval(*a, **k):
        n0 = by_thread.get(me, 0)
        t = time.perf_counter()
        rew = eval_episode(*a, **k)
        evals.append((rew, by_thread.get(me, 0) - n0,
                      time.perf_counter() - t))
        return rew

    sac_mod.SAC.collect, sac_mod.SAC.train_iter = timed_collect, counted_iter
    sac_train.eval_episode = counted_eval
    try:
        argv = [*SAC_ARGV, "--out", out_dir]
        print("python -m deepmimic_mujoco_tpu_torch.rl.sac_train "
              + " ".join(repr(a) if " " in a else a for a in argv))
        s = sac_train.main(argv)
    finally:
        sac_mod.SAC.collect, sac_mod.SAC.train_iter = collect, train_iter
        sac_train.eval_episode = eval_episode
    sac = trainers[0]
    cfg = sac.cfg
    rows = [json.loads(line) for line in open(sorted(glob.glob(
        os.path.join(out_dir, "*_metrics.jsonl")))[-1])]
    conf = rows[0]["config"]
    check((conf["n_envs"], conf["buffer_size"], conf["batch_size"],
           tuple(conf["arch"]), cfg.steps_per_iter, cfg.updates_per_iter)
          == (256, 1_000_000, 1024, (1024, 512), 32, 32),
          f"not the SAC CLI's default widths: {conf}")
    iters = rows[1:]
    check(len(iters) == 2, f"{len(iters)} SAC iterations logged, not 2")
    per_it = [t for t in times if t[0] == "train_iter"]
    coll = [t for t in times if t[0] == "collect"]
    launches = [t[2] for t in per_it]
    floor = math.exp(cfg.log_alpha_min)
    for i, r in enumerate(iters):
        it_s, col_s = per_it[i][1], coll[i][1]
        print(f"SAC iteration {i + 1} on {card}: "
              f"{SAC_PER_ITER / it_s:.1f} env-steps/s ({it_s:.3f} s: "
              f"collect {col_s:.3f} s for {cfg.steps_per_iter} steps of "
              f"{cfg.n_envs} envs, updates {it_s - col_s:.3f} s for "
              f"{cfg.updates_per_iter} x {cfg.batch_size}); critic_loss "
              f"{r['critic_loss']:.6f} actor_loss {r['actor_loss']:.6f} "
              f"alpha {r['alpha']:.6f} mean_reward {r['mean_reward']:.4f} "
              f"ep_return {r['ep_return']:.3f} ep_length "
              f"{r['ep_length']:.1f} eval_ep_rew "
              f"{r.get('eval_ep_rew', float('nan')):.2f}; kernel launches "
              f"in the training thread {launches[i]}")
        check(math.isfinite(r["critic_loss"])
              and math.isfinite(r["actor_loss"]),
              f"non-finite SAC losses in iteration {i + 1}: {r}")
        check(r["alpha"] >= floor * (1 - 1e-6),
              f"alpha {r['alpha']} below exp(log_alpha_min) = {floor}")
    check(launches == [cfg.steps_per_iter] * 2,
          f"kernel launches per SAC iteration: {launches}")
    nbytes = sac_mod.buffer_bytes(s.buffer)
    print(f"replay buffer on {card}: {cfg.buffer_size:,} rows x "
          f"(2 x {sac.env.obs_size} + {sac.env.action_size} + 2) float32 "
          f"= {nbytes:,} bytes ({nbytes / 2**20:.1f} MiB); buf_pos "
          f"{s.buf_pos}, full {s.buf_full}")
    print(f"evaluations on {card}: " + ", ".join(
        f"reward {r:.2f} ({n} launches, {t:.2f} s)" for r, n, t in evals))
    check(len(evals) == 2 and all(0 < n <= 1000 for _, n, _ in evals),
          f"evaluations: {evals}")
    best = glob.glob(os.path.join(out_dir, "*_best_actor.npz"))
    check(best, "no best-actor checkpoint written")

    # one update step, profiled
    valid = cfg.buffer_size if s.buf_full else max(s.buf_pos, 1)
    step = lambda: sac.update_step(s, valid, 1.0)
    k, d_ms, w_ms = profiled_calls(step, 10)
    up_ms = wall_ms(step, 20)
    print(f"SAC update step (batch {cfg.batch_size}, net "
          f"{cfg.net_arch}, twin critics, three Adams) on {card}: "
          f"{k:.0f} device kernels, device busy {d_ms:.4f} ms of "
          f"{w_ms:.4f} ms wall ({100 * d_ms / w_ms:.1f}%) under the "
          f"profiler; {up_ms:.4f} ms per update unprofiled")
    return launches, [n for _, n, _ in evals], dict(
        env_steps_per_s=[SAC_PER_ITER / t[1] for t in per_it],
        collect_s=[t[1] for t in coll],
        update_s=[p[1] - c[1] for p, c in zip(per_it, coll)],
        buffer_bytes=nbytes, eval_rewards=[r for r, _, _ in evals],
        update_kernels=k, update_busy_share=d_ms / w_ms)


def sac_distill(card, env):
    """Phase 11: distill_actor_from_ppo from the h3d walk gate actor at
    its defaults (4096 envs x 64 steps under the PPO mean, 3000 BC
    steps). The kernel is first held against its plain version on the
    rollout's first-step inputs and timed; then the counts are zeroed
    and the distill must launch it 64 times. The distilled actor is
    written for its replay. Returns (launches, the kernel's numbers)."""
    import torch

    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.rl import checkpoint, sac_train
    from deepmimic_mujoco_tpu_torch.rl.sac import SAC, SACConfig

    teacher = os.path.join(REPO, "deepmimic_mujoco_tpu_torch", "data",
                           DISTILL_TEACHER)
    dev = env.device
    with torch.no_grad():
        ppo_net = sac_train.load_ppo_policy(teacher, env)
        g = torch.Generator(device=dev).manual_seed(16)
        state, obs = env.reset(4096, generator=g)
        args, kw = capture_parts(env, state, ppo_net(obs)[0])
    k_numbers = kernel_on_main_path("SAC distill h3d", card, args, kw)
    del args, state, obs

    sac = SAC(env, SACConfig())
    collect = sac_train.collect_ppo_states
    spans = []

    def timed_collect(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = collect(*a, **k)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t)
        return out

    sac_train.collect_ppo_states = timed_collect
    torch.cuda.synchronize()
    fs.fused_solve.launches = 0
    try:
        t = time.perf_counter()
        actor_sd, losses = sac_train.distill_actor_from_ppo(sac, env,
                                                            teacher)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        launches = fs.fused_solve.launches
    finally:
        sac_train.collect_ppo_states = collect
    losses = losses.cpu()
    print(f"distill on {card}: rollout 4096 envs x "
          f"{sac_train.DISTILL_HORIZON} steps {spans[0]:.3f} s "
          f"({launches} kernel launches), {len(losses)} BC steps "
          f"{total - spans[0]:.3f} s; bc loss step 0 {float(losses[0]):.5f}"
          f", last {float(losses[-1]):.5f}, min {float(losses.min()):.5f}")
    check(launches == sac_train.DISTILL_HORIZON,
          f"distill rollout launched the kernel {launches} times")
    check(float(losses[-1]) < float(losses[0]),
          "the BC loss did not fall below its step-0 value")
    actor = sac.make_actor()
    actor.load_state_dict(actor_sd)
    checkpoint.save_sac_actor_npz(DISTILLED, actor)
    return launches, k_numbers


def hold_random(card, dev, label, nv, K, L, B=2048):
    """Phase 16 (a): both entries, both cones, on random systems of one
    size (SPD M, contact-Jacobian parts, nonzero lam0), held against the
    plain version evaluated in float64, scaled by the batch and by each
    env (the float32 plain version's distance beside it); the elliptic
    holds timed (kernel, kernel, plain, plain) beside the bound. Returns
    the numbers of the kernels line."""
    import torch

    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs

    n = 3 * K + L
    plan = fs.launch_plan(nv, n, K)
    check(plan.shared, f"{label} K {K} is not the shared-memory plan")
    args = [torch.as_tensor(a, device=dev)
            for a in random_systems(B + K, B, nv, K, L)]
    parts, ld_idx = random_parts(2 * B + K, B, nv, K, L)
    parts = [torch.as_tensor(a, device=dev) for a in parts]
    M, JT, vectors = args[0], args[1], args[2:]
    names = ("qacc", "qfrc", "lam")
    out = {"plan": plan.label, "smem_bytes": plan.smem_bytes,
           "max_abs_err": 0.0, "explicit_max_abs_err": 0.0}
    for pyr in (False, True):
        kw = dict(K=K, L=L, iterations=50, pyramidal=pyr)
        for entry in ("explicit", "parts"):
            jt = JT if entry == "explicit" else fs.build_jt(*parts, ld_idx)
            ker = ((lambda: fs.fused_solve(*args, **kw)) if entry == "explicit"
                   else (lambda: fs.fused_solve_parts(
                       M, *parts, *vectors, ld_idx=ld_idx, **kw)))
            plain = lambda a=(M, jt, *vectors): fs.fused_solve_plain(*a, **kw)
            got = ker()
            torch.cuda.synchronize()
            ref = plain([a.double() for a in (M, jt, *vectors)])
            ref32 = plain()
            errs = {k: scaled_err(a, b) for k, a, b in zip(names, ref, got)}
            env_errs = {k: env_scaled_err(a, b)
                        for k, a, b in zip(names, ref, got)}
            e32 = max(env_scaled_err(a, b) for a, b in zip(ref, ref32))
            max_abs = max(float((a - b).abs().max())
                          for a, b in zip(ref, got))
            key = "" if entry == "parts" else "explicit_"
            out[f"{key}max_abs_err"] = max(out[f"{key}max_abs_err"],
                                           max_abs)
            print(f"{entry} {label} nv={nv} K={K} L={L} B={B} "
                  f"{'pyramidal' if pyr else 'elliptic'} ({plan.label}) vs "
                  f"plain (float64): scaled by the batch "
                  + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                  + "; by each env " + " ".join(
                      f"{k}={v:.2e}" for k, v in env_errs.items())
                  + f"; max_abs {max_abs:.2e}; the float32 plain version "
                  f"by each env {e32:.2e}")
            check(all(v < TOL_KERNEL for v in errs.values())
                  and all(v < TOL_KERNEL for v in env_errs.values()),
                  f"{entry} kernel disagrees with plain (float64) at "
                  f"{label} K {K}: {errs} {env_errs}")
            if pyr:
                continue
            p1, k1, k2, p2 = (time_ms(plain, 3), time_ms(ker, 10),
                              time_ms(ker, 10), time_ms(plain, 3))
            b_ms, b_by = fs.bound_ms(B, nv, K, L, 50, entry=entry)
            k_ms = (k1 + k2) / 2
            print(f"  {entry} {label} K={K} B={B} on {card}: kernel "
                  f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
                  f"bound {b_ms:.4g} ms ({b_by}), {100 * b_ms / k_ms:.3g}% "
                  "of the bound")
            out.update({f"{key}ms": k_ms, f"{key}plain_ms": (p1 + p2) / 2,
                        f"{key}bound_ms": b_ms, f"{key}bound_by": b_by})
    out.update(shared_plan_profile(
        card, dev, f"{label} K {K}", (M, *parts, *vectors),
        dict(K=K, L=L, ld_idx=ld_idx, iterations=50)))
    return out


def shared_plan_profile(card, dev, label, args, kw):
    """The plan's registers, spills, shared bytes and blocks per SM, the
    parts entry's time by batch (one env per SM, one wave, all of
    ``args``) and its clock64() cycles per phase (mean over the envs of
    thread 0), as phase 3 prints them for the register plan."""
    import torch

    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs

    B, nv = args[0].shape[:2]
    K, L = kw["K"], kw["L"]
    info = fs.kernel_info(nv, 3 * K + L, K, parts=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_wave = sms * info["blocks_per_sm"]
    by_batch = {}
    for b in sorted({sms, min(per_wave, B), B}):
        sub = [a[:b] for a in args]
        by_batch[b] = time_ms(lambda: fs.fused_solve_parts(*sub, **kw), 10)
    clocks = fs.phase_cycles(*args, **kw)
    cyc = (clocks[:, 1:] - clocks[:, :-1]).double().mean(0).tolist()
    total = sum(cyc)
    print(f"  {label} ({info['plan'].label}) on {card}: {info['regs']} "
          f"registers, {info['spill_bytes']} local bytes, "
          f"{info['smem_bytes']} B shared, {info['blocks_per_sm']} blocks "
          f"per SM ({per_wave} envs per wave); time by batch "
          + ", ".join(f"B={b} {t:.4f} ms" for b, t in by_batch.items())
          + f"; cycles per env ({total:.0f} in all): " + ", ".join(
              f"{name} {c:.0f} ({100 * c / total:.1f}%)"
              for name, c in zip(fs.PHASES, cyc)))
    check(all(c > 0 for c in cyc), f"phase clocks not increasing: {cyc}")
    check(info["spill_bytes"] == 0, f"local memory at {label}")
    return {"regs": info["regs"], "spill_bytes": info["spill_bytes"],
            "blocks_per_sm": info["blocks_per_sm"],
            "ms_by_batch": {str(b): t for b, t in by_batch.items()},
            "phase_cycles": dict(zip(fs.PHASES, cyc))}


def nine_states(model):
    """The nine G1 states of tests/test_torch_g1.py's fixture, made the
    same way with the port's clip loader: four walk frames, four of them
    jittered and sunk 0-4 cm, and the getup clip's first (prone) pose
    sunk 6 cm; with the fixture's ctrl. Returns (qpos, qvel, ctrl), numpy
    float32."""
    import numpy as np

    from deepmimic_mujoco_tpu_torch.mocap.loader import load_clip
    from deepmimic_mujoco_tpu_torch.models import assets

    walk = load_clip(assets.mocap_path("unitree_g1", "walk"), model)
    getup = load_clip(assets.mocap_path("unitree_g1", GETUP_MOTION), model)
    r = np.random.RandomState(0)
    q = walk.qpos[np.arange(0, len(walk), len(walk) // 4)[:4]]
    qp = q.copy()
    qp[:, 7:] += r.uniform(-0.1, 0.1, qp[:, 7:].shape)
    qp[:, 2] -= r.uniform(0.0, 0.04, len(qp))
    prone = getup.qpos[:1].copy()
    prone[:, 2] -= 0.06
    qpos = np.concatenate([q, qp, prone]).astype(np.float32)
    qvel = np.concatenate([walk.qvel[:len(q)], walk.qvel[:len(q)],
                           getup.qvel[:1]]).astype(np.float32)
    ctrl = (r.uniform(-1, 1, (len(qpos), model.nu)) * 20).astype(np.float32)
    return qpos, qvel, ctrl


def contact_rich_batch(card, dev, B=2048):
    """Phase 16 (b): the nine states tiled to B, one Euler step at
    CONTACT_RICH_K slots on the card: the active contacts and the
    overflow beside 24 slots, the kernel held and timed on the step's
    inputs, and the nine distinct envs against the port's CPU path.
    Returns the numbers of the kernels line."""
    import numpy as np
    import torch

    from deepmimic_mujoco_tpu_torch.models import assets, load_model
    from deepmimic_mujoco_tpu_torch.models.physics_model import EULER
    from deepmimic_mujoco_tpu_torch.physics.collision import collide
    from deepmimic_mujoco_tpu_torch.physics.kinematics import (
        fwd_kinematics,
    )
    from deepmimic_mujoco_tpu_torch.physics.step import Engine

    model = load_model(assets.xml_path("unitree_g1"))
    qpos, qvel, ctrl = nine_states(model)
    tile = lambda x: torch.as_tensor(
        np.tile(x, (-(-B // len(x)), 1))[:B], device=dev)
    q, v, u = tile(qpos), tile(qvel), tile(ctrl)
    eng = Engine(model, max_contacts=CONTACT_RICH_K, integrator=EULER,
                 device=dev)
    check(eng.solve_plan.shared, f"the engine's plan {eng.solve_plan}")
    kin = fwd_kinematics(model, q[:9])
    c = collide(model, eng.tables, kin, CONTACT_RICH_K)
    active = (c.dist < c.includemargin).sum(1).tolist()
    ov = c.overflow.tolist()
    ov24 = collide(model, eng.tables, kin, 24).overflow.tolist()
    print(f"contact-rich G1 batch (the nine states of tests/test_torch_g1.py"
          f" tiled to B {B}): active contacts {active}; overflow at "
          f"{CONTACT_RICH_K} slots {ov}, at 24 slots {ov24}")
    check(not any(ov), f"contacts dropped at {CONTACT_RICH_K} slots: {ov}")
    check(ov24[-1] > 0, f"the prone env drops nothing at 24 slots: {ov24}")
    args, kw = capture_solve(lambda: eng.step(q, v, u,
                                              lam0=eng.empty_lam(B)))
    check(kw["K"] == CONTACT_RICH_K, f"the step's solve has K {kw['K']}")
    hold = kernel_on_main_path(f"contact-rich G1 K {CONTACT_RICH_K}", card,
                               args, kw)
    # the nine distinct envs on the card against the CPU path
    cpu = Engine(model, max_contacts=CONTACT_RICH_K, integrator=EULER,
                 device="cpu")
    got = eng.step(q[:9], v[:9], u[:9], lam0=eng.empty_lam(9))
    want = cpu.step(*(torch.as_tensor(x) for x in (qpos, qvel, ctrl)),
                    lam0=cpu.empty_lam(9))
    errs = {k: scaled_err(w, g) for k, w, g in (
        ("qpos", want[0], got[0]), ("qvel", want[1], got[1]),
        ("qacc", want[2].qacc, got[2].qacc),
        ("qfrc_constraint", want[2].qfrc_constraint,
         got[2].qfrc_constraint))}
    print("  the nine envs' step, card vs CPU path: scaled err "
          + " ".join(f"{k}={e:.2e}" for k, e in errs.items()))
    check(all(e < TOL_STEP for e in errs.values()),
          f"the contact-rich step disagrees with the CPU path: {errs}")
    return dict(hold, active=active, overflow=ov, overflow_24=ov24,
                step_err=errs)


def getup_rollout(card, dev, k, n_envs=2048, n_steps=64):
    """Phase 16 (c): n_envs G1 getup envs at k contact slots under a
    seeded ActorCritic, n_steps of step_auto_reset with the counts zeroed
    (rollout_counted): the launches by plan, the overflow summed and its
    largest, env-steps/s. At CONTACT_RICH_K the kernel is held on the
    first step's inputs first. Returns the numbers of the kernels line."""
    import torch

    from deepmimic_mujoco_tpu_torch.envs import DPEnv
    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.rl import networks

    with torch.no_grad():
        env = DPEnv(motion=GETUP_MOTION, robot="unitree_g1", max_contacts=k,
                    device=dev)
        plan = env.engine.solve_plan
        net = networks.ActorCritic(
            env.obs_size, env.action_size, device="cpu",
            generator=torch.Generator().manual_seed(16)).to(dev)
        g_rsi = torch.Generator(device=dev).manual_seed(17)
        g_act = torch.Generator(device=dev).manual_seed(18)
        state, obs = env.reset(n_envs, generator=g_rsi)
        mean, log_std, _ = net(obs)
        action, _ = networks.sample_action(mean, log_std, g_act)
        hold = {}
        if k == CONTACT_RICH_K:
            args, kw = capture_parts(env, state, action)
            hold = kernel_on_main_path(f"getup rollout K {k}", card, args,
                                       kw)
        ov_sum = torch.zeros((), dtype=torch.int64, device=dev)

        def step(s, a):
            nonlocal ov_sum
            s, out = env.step_auto_reset(s, a, g_rsi)
            ov_sum += out.contact_overflow.sum()
            return s, out

        _, _, launches, wall, n_done, ov = rollout_counted(
            env, net, state, action, n_steps, g_rsi, g_act, step=step)
        by_plan = dict(fs.fused_solve.launches_by_plan)
    sps = n_envs * n_steps / wall
    print(f"getup rollout at {k} slots ({plan.label}) on {card}: {n_envs} "
          f"envs x {n_steps} steps in {wall:.3f} s = {sps:.1f} env-steps/s "
          f"({n_done} resets); launches by plan {by_plan}; contact overflow "
          f"summed {int(ov_sum)}, largest {ov}")
    check(by_plan == {plan.label: n_steps},
          f"launches by plan {by_plan}, expected {n_steps} of {plan.label}")
    return dict(hold, launches=launches, plan=plan.label,
                env_steps_per_s=sps, overflow_sum=int(ov_sum),
                overflow_max=ov, resets=n_done)


def getup_b1_hold(card, dev):
    """The kernel at B 1 at CONTACT_RICH_K slots, the batch of the getup
    gate replay at those slots: the first step of the gate actor from
    frame 0 (prone: contacts at once)."""
    import torch

    from deepmimic_mujoco_tpu_torch.envs import DPEnv
    from deepmimic_mujoco_tpu_torch.rl.convert import actor_from_npz

    actor_file, motion, robot, idx0, _, _ = GATES["g1_getup"]
    env = DPEnv(motion=motion, robot=robot, max_contacts=CONTACT_RICH_K,
                device=dev)
    actor = actor_from_npz(os.path.join(
        REPO, "deepmimic_mujoco_tpu_torch", "data", actor_file), device=dev)
    with torch.no_grad():
        state, obs = env.reset(1, idx_init=idx0)
        args, kw = capture_parts(env, state, actor(obs)[0])
    check(bool(args[-3].any()), "no active constraint on the first step")
    return kernel_on_main_path(f"g1_getup_k{CONTACT_RICH_K}_b1 (the gate "
                               "replay's batch)", card, args, kw)


def contact_rich(card, dev, res, g1_sps=None):
    """Phase 16: the kernel's shared-memory plan on random systems of its
    sizes (a), on the contact-rich G1 batch (b), in the getup rollout at
    CONTACT_RICH_K slots beside 24 (c), and at B 1 for the getup gate
    replayed at CONTACT_RICH_K slots (d, whose replay ``res`` holds, beside
    the gate at 24). Returns the paths of the kernels line."""
    paths = {}
    for robot, nv, K, L in CONTACT_RICH_RANDOM:
        paths[f"random_{robot}_k{K}_b2048"] = hold_random(
            card, dev, robot, nv, K, L)
    paths["contact_rich_g1_k128_b2048"] = contact_rich_batch(card, dev)
    roll = {k: getup_rollout(card, dev, k) for k in (CONTACT_RICH_K, 24)}
    hi, lo = roll[CONTACT_RICH_K], roll[24]
    print(f"getup rollout on {card}: {hi['env_steps_per_s']:.1f} env-steps/s"
          f" at {CONTACT_RICH_K} slots, {lo['env_steps_per_s']:.1f} at 24"
          + (f", {g1_sps:.1f} in phase 4 (G1 walk at 24)" if g1_sps else "")
          + f"; contact overflow summed {hi['overflow_sum']} at "
          f"{CONTACT_RICH_K} slots, {lo['overflow_sum']} at 24")
    paths[f"getup_rollout_k{CONTACT_RICH_K}_b2048"] = dict(
        hi, k24=lo, g1_walk_env_steps_per_s=g1_sps)
    name = f"g1_getup_k{CONTACT_RICH_K}"
    paths[f"{name}_b1"] = getup_b1_hold(card, dev)
    r, r24 = res[name], res["g1_getup"]
    gate = GATES["g1_getup"][4]
    print(f"G1 getup gate replay at {CONTACT_RICH_K} slots on {card}: reward "
          f"{r['reward']:.2f} over {r['length']} steps (at 24 slots "
          f"{r24['reward']:.2f}; gate {gate}), max contact overflow "
          f"{r['overflow']} (at 24: {r24['overflow']}); {r['launches']} "
          f"kernel launches in {r['steps']} steps, by plan {r['plans']}")
    check(r["reward"] > gate, f"{name} gate reward {r['reward']:.2f}")
    check(r["overflow"] == 0, f"{name} dropped {r['overflow']} contacts")
    check(r["launches"] == r["steps"] and len(r["plans"]) == 1
          and next(iter(r["plans"])).startswith("shared"),
          f"{name}: {r['launches']} launches in {r['steps']} steps, "
          f"{r['plans']}")
    paths[f"{name}_gate"] = dict(launches=r["launches"], reward=r["reward"],
                                 reward_k24=r24["reward"], steps=r["steps"],
                                 held_at=f"{name}_b1")
    return paths


def build_kernels():
    """Phase 1: nvcc of the kernel and its phase-clock twin in parallel,
    ptxas's registers and spills (a spill fails the run), and each
    plan's registers, shared memory and blocks per SM at humanoid3d and
    G1 (the register plans at their main paths' slots, the shared-memory
    plan's instances at 26, 48 and CONTACT_RICH_K slots, and at 60
    dofs).
    Returns (spill bytes, {label: kernel_info})."""
    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs

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
    for label, (nv, K, L) in (
            ("h3d", (34, 16, 28)), ("g1", (43, 24, 37)),
            ("g1_k26", (43, 26, 37)),
            ("g1_k48", (43, 48, 37)), (f"g1_k{CONTACT_RICH_K}",
                                       (43, CONTACT_RICH_K, 37)),
            (f"h3d_k{CONTACT_RICH_K}", (34, CONTACT_RICH_K, 28)),
            ("nv60_k10", (60, 10, 50))):
        info[label] = fs.kernel_info(nv, 3 * K + L, K, parts=True)
        pl = info[label]["plan"]
        print(f"fused_solve plan at {label} (nv={nv}, K={K}, L={L}): "
              f"{pl.threads_per_env} threads per env ({pl.label}), "
              f"{pl.envs_per_block} env per block, {pl.w_regs} W values "
              f"per thread in registers; {info[label]['regs']} registers, "
              f"{info[label]['spill_bytes']} local bytes, "
              f"{info[label]['smem_bytes']} B dynamic shared memory, "
              f"{info[label]['blocks_per_sm']} blocks per SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
        check(info[label]["smem_bytes"] == pl.smem_bytes,
              f"launch_plan's shared memory {pl.smem_bytes} B differs from "
              f"the kernel's {info[label]['smem_bytes']} B")
        check(info[label]["spill_bytes"] == 0, f"local memory at {label}")
        check(pl.shared == ("_k" in label), f"{label} takes {pl.label}")
    return spills, info


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0].strip()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from deepmimic_mujoco_tpu_torch.envs import DPEnv
    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.rl import networks
    from deepmimic_mujoco_tpu_torch.utils.device import fp32_physics

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    fp32_physics()

    # ---- 0. card ----------------------------------------------------------
    t0 = phase("card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")
    has = render_modules()
    absent = [m for m, ok in has.items() if not ok]
    print("render modules: " + ", ".join(
        f"{m} {'present' if ok else 'ABSENT'}" for m, ok in has.items())
        + (f"; without {' and '.join(absent)} the parts that draw with it "
           "are left out (the dashboard's panel and plots need matplotlib; "
           "overlays and videos need cv2) and are held by the CPU tests "
           "only" if absent else ""))
    done(t0, "card")

    # ---- 1. build -----------------------------------------------------------
    t0 = phase("build")
    spills, info = build_kernels()
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
        main_args, main_kw = capture_parts(env, state, action)
        h3d_k = kernel_on_main_path("h3d", card, main_args, main_kw)
        kernel = fs.fused_solve_parts
        # waves: one env is one block, so B beyond blocks-per-SM x SMs
        # adds a wave of the same length
        B_m = main_args[0].shape[0]
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

        state, action, h3d_launches, wall, n_done, _ = rollout_counted(
            env, net, state, action, n_steps, g_rsi, g_act)
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
          f"(policy + sampling + step_auto_reset; {n_done} resets)")
    done(t0, "main path")

    del env, cpu_env

    # ---- 4. G1 main path ---------------------------------------------------
    t0 = phase("G1 main path")
    with torch.no_grad():
        g1 = DPEnv(motion="walk", robot="unitree_g1", device=dev)
        net = networks.ActorCritic(
            g1.obs_size, g1.action_size, device="cpu",
            generator=torch.Generator().manual_seed(3)).to(dev)
        g_rsi = torch.Generator(device=dev).manual_seed(4)
        g_act = torch.Generator(device=dev).manual_seed(5)
        state, obs = g1.reset(n_envs, generator=g_rsi)
        mean, log_std, _ = net(obs)
        action, _ = networks.sample_action(mean, log_std, g_act)
        g1_args, g1_kw = capture_parts(g1, state, action)
        check((g1_kw["K"], g1_kw["L"]) == (24, 37),
              f"G1 solve has K={g1_kw['K']}, L={g1_kw['L']}")
        g1_k = kernel_on_main_path("G1", card, g1_args, g1_kw)
        state, action, g1_launches, wall, n_done, ov = rollout_counted(
            g1, net, state, action, n_steps, g_rsi, g_act)
    g1_sps = n_envs * n_steps / wall
    print(f"G1 main path on {card}: {n_envs} envs x {n_steps} steps in "
          f"{wall:.3f} s = {g1_sps:.1f} env-steps/s "
          f"(policy + sampling + step_auto_reset; {n_done} resets), "
          f"max contact overflow {ov}")
    done(t0, "G1 main path")

    # ---- 5. PPO training ---------------------------------------------------
    t0 = phase("PPO training")
    import glob
    import shutil

    dashboard = not absent
    ppo_dir = os.path.join(REPO, "build", "ppo_smoke")
    shutil.rmtree(ppo_dir, ignore_errors=True)
    if not dashboard:
        print(f"PPO training with --no-render: the dashboard needs "
              f"{' and '.join(absent)}")
    ppo_run = ppo_training(
        card, dev, PPO_ARGV if dashboard else [*PPO_ARGV, "--no-render"],
        "ppo_smoke", env=g1)
    ppo_launches, eval_launches = ppo_run["launches"], ppo_run["eval_launches"]
    if dashboard:
        videos = glob.glob(os.path.join(ppo_dir, "*_videos",
                                        "global_step_*.mp4"))
        plots = glob.glob(os.path.join(ppo_dir, "*_videos", "*_plot.png"))
        n_frames = [video_frames(v) for v in videos]
        print(f"eval dashboard under build/ppo_smoke: "
              + ", ".join(f"{os.path.basename(v)} ({n} frames)"
                          for v, n in zip(videos, n_frames))
              + "; " + ", ".join(sorted(os.path.basename(p) for p in plots)))
        check(videos and all(n >= 1 for n in n_frames),
              f"dashboard videos {videos} with {n_frames} frames")
        check(sorted(os.path.basename(p) for p in plots)
              == ["len_plot.png", "rew_plot.png"], f"dashboard plots {plots}")
    done(t0, "PPO training")

    # ---- 6. combined main path -------------------------------------------
    t0 = phase("combined main path")
    from deepmimic_mujoco_tpu_torch.envs import (
        DPCombinedEnv, DPCombinedEnvConfig,
    )
    from deepmimic_mujoco_tpu_torch.envs.combined_env import MOTION_NAMES
    from deepmimic_mujoco_tpu_torch.models.physics_model import RK4

    del g1
    with torch.no_grad():
        comb = DPCombinedEnv(cfg=DPCombinedEnvConfig(
            HANDOFF_BUFFER_FRAC=0.25, FACEDOWN_RSI_FRAC=0.1,
            RSI_RANDOM_PA=True), device=dev)
        net = networks.ActorCritic(
            comb.obs_size, comb.action_size, device="cpu",
            generator=torch.Generator().manual_seed(7)).to(dev)
        g_rsi = torch.Generator(device=dev).manual_seed(8)
        g_act = torch.Generator(device=dev).manual_seed(9)
        state, obs = comb.reset(n_envs, generator=g_rsi)
        mean, log_std, _ = net(obs)
        action, _ = networks.sample_action(mean, log_std, g_act)
        c_args, c_kw = capture_parts(comb, state, action)
        check((c_kw["K"], c_kw["L"]) == (24, 37),
              f"combined solve has K={c_kw['K']}, L={c_kw['L']}")
        comb_k = kernel_on_main_path("combined", card, c_args, c_kw)
        (state, action, comb_launches, wall, n_done, ov), buf, trans = \
            combined_rollout(comb, net, state, action, n_steps, g_rsi, g_act)
    handoff_count = int(buf.count)
    print(f"combined main path on {card}: {n_envs} envs x {n_steps} steps "
          f"in {wall:.3f} s = {n_envs * n_steps / wall:.1f} env-steps/s "
          f"(policy + sampling + step_auto_reset + handoff buffer update; "
          f"{n_done} resets), max contact overflow {ov}, handoff_count "
          f"{handoff_count}")
    print("  motion transitions (from -> to: count): " + ", ".join(
        f"{MOTION_NAMES[i]}->{MOTION_NAMES[j]}: {int(trans[i, j])}"
        for i in range(4) for j in range(4) if i != j and trans[i, j]))
    check(int(trans.sum()) == n_envs * n_steps, "transition counts")
    del comb
    done(t0, "combined main path")

    # ---- 7. RK4 main path --------------------------------------------------
    t0 = phase("RK4 main path")
    rk4_steps = 16
    with torch.no_grad():
        rk4 = DPEnv(motion="walk", robot="humanoid3d", integrator=RK4,
                    device=dev)
        net = networks.ActorCritic(
            rk4.obs_size, rk4.action_size, device="cpu",
            generator=torch.Generator().manual_seed(10)).to(dev)
        g_rsi = torch.Generator(device=dev).manual_seed(11)
        g_act = torch.Generator(device=dev).manual_seed(12)
        state, obs = rk4.reset(n_envs, generator=g_rsi)
        mean, log_std, _ = net(obs)
        action, _ = networks.sample_action(mean, log_std, g_act)
        r_args, r_kw = capture_parts(rk4, state, action)
        check(bool((r_args[-1] == 0).all()), "an RK4 stage was warm-started")
        rk4_k = kernel_on_main_path("RK4 h3d (stage 1, lam0 = 0)", card,
                                    r_args, r_kw)
        state, action, rk4_launches, wall, n_done, ov = rollout_counted(
            rk4, net, state, action, rk4_steps, g_rsi, g_act, per_step=4)
    print(f"RK4 main path on {card}: {n_envs} envs x {rk4_steps} steps in "
          f"{wall:.3f} s = {n_envs * rk4_steps / wall:.1f} env-steps/s "
          f"(4 forwards a step; {n_done} resets), max contact overflow {ov}")
    done(t0, "RK4 main path")

    del rk4

    # ---- 8. PPO on the combined env ---------------------------------------
    t0 = phase("PPO combined")
    comb_run = ppo_training(card, dev, PPO_COMBINED_ARGV,
                            "ppo_combined_smoke")
    comb_ppo, comb_eval, comb_handoff = (
        comb_run["launches"], comb_run["eval_launches"], comb_run["handoff"])
    check(comb_handoff[-1] is not None and comb_handoff[-1] > 0,
          f"handoff_count after the iterations: {comb_handoff}")
    done(t0, "PPO combined")

    # ---- 9. SAC main path --------------------------------------------------
    t0 = phase("SAC main path")
    from deepmimic_mujoco_tpu_torch.rl.sac import (
        SAC, SACConfig, squash_sample,
    )
    from deepmimic_mujoco_tpu_torch.tools import profiling

    with torch.no_grad():
        env = DPEnv(motion="walk", robot="humanoid3d", device=dev)
        sac_cfg = SACConfig()
        sac = SAC(env, sac_cfg)
        actor = sac.make_actor(torch.Generator().manual_seed(13))
        g_rsi = torch.Generator(device=dev).manual_seed(14)
        g_act = torch.Generator(device=dev).manual_seed(15)
        state, obs = env.reset(sac_cfg.n_envs, generator=g_rsi)
        mean, log_std = actor(obs)
        a, _ = squash_sample(mean, log_std, torch.randn(
            mean.shape, generator=g_act, device=dev))
        s_args, s_kw = capture_parts(env, state, a * sac_cfg.action_scale)
        sac_k = kernel_on_main_path("SAC h3d", card, s_args, s_kw)
        del s_args, state, obs, actor
    done(t0, "SAC main path")

    # ---- 10. SAC training --------------------------------------------------
    t0 = phase("SAC training")
    sac_launches, sac_eval, sac_numbers = sac_training(card)
    done(t0, "SAC training")

    # ---- 11. distill --------------------------------------------------------
    t0 = phase("SAC distill")
    distill_launches, distill_k = sac_distill(card, env)
    done(t0, "SAC distill")

    # ---- 12. tools ----------------------------------------------------------
    t0 = phase("tools")
    print(f"profiling.stage_breakdown(humanoid3d walk, batch 2048) on "
          f"{card}:")
    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs

    n0 = fs.fused_solve.launches
    stages = profiling.stage_breakdown(env, 2048, steps=8)
    launches = fs.fused_solve.launches - n0
    check([name for name, _ in stages][:1] == ["env.step"]
          and "engine.solve" in dict(stages) and launches == 9,
          f"stage rows {[name for name, _ in stages]} and {launches} "
          f"kernel launches in the warm-up and 8 steps")
    print(f"profiling.throughput_sweep(humanoid3d walk) on {card}:")
    sweep = profiling.throughput_sweep(env, SWEEP_BATCHES)
    print("  batch | env-steps/s\n" + "\n".join(
        f"  {b:5d} | {sps:.1f}" for b, sps in sweep))
    # the kernel at B 1, the batch of the rendered paths of phase 14, held
    # once per plan: h3d (the dashboard's episode and the viewer's policy:
    # the h3d walk gate actor) and G1 (play and play --video: the
    # extracted run artifact), each from frame 20 on its first step with
    # an active constraint row (the start poses touch nothing at first)
    import numpy as np

    from deepmimic_mujoco_tpu_torch.envs import DPEnv
    from deepmimic_mujoco_tpu_torch.rl.convert import actor_from_npz
    from deepmimic_mujoco_tpu_torch.rl.extracted_policy import (
        ExtractedPolicy,
    )

    data = os.path.join(REPO, "deepmimic_mujoco_tpu_torch", "data")
    gate_actor = actor_from_npz(os.path.join(data, DISTILL_TEACHER),
                                device=dev)
    extracted = ExtractedPolicy(os.path.join(data, "run_extracted.npz"))
    g1_env = DPEnv(motion="run", robot="unitree_g1", device=dev)
    b1 = {}
    for name, b1_env, policy in (
            ("h3d_b1", env, lambda o: gate_actor(o)[0]),
            ("g1_b1", g1_env, lambda o: torch.as_tensor(np.asarray(
                extracted.act(o[0].cpu().numpy()), np.float32),
                device=dev)[None])):
        with torch.no_grad():
            state, obs = b1_env.reset(1, idx_init=20)
            for step in range(50):
                action = policy(obs)
                args, kw = capture_parts(b1_env, state, action)
                if bool(args[-3].any()):       # the active mask
                    break
                state, out = b1_env.step(state, action)
                obs = out.obs
            check(bool(args[-3].any()),
                  f"{name}: no active constraint in 50 steps")
        b1[name] = dict(kernel_on_main_path(
            f"{name} (rendered paths; step {step})", card, args, kw),
            step=step)
    del env, g1_env
    done(t0, "tools")

    # ---- 13. data parallel ------------------------------------------------
    t0 = phase("data parallel")
    dp = data_parallel(card, dev)
    done(t0, "data parallel")

    # ---- 14. gate replays -------------------------------------------------
    t0 = phase("gate replays")
    res = run_replays(card, REPLAYS, REPLAY_TIMEOUT)
    for name, (_, motion, robot, idx0, gate, jax_rew) in GATES.items():
        r = res[name]
        print(f"{robot} {motion} gate replay on {card}: reward "
              f"{r['reward']:.2f} over {r['length']} steps from frame {idx0} "
              f"(JAX replay {jax_rew}, gate {gate}), max contact overflow "
              f"{r['overflow']}")
        check(r["reward"] > gate, f"{name} gate reward {r['reward']:.2f}")
        check(r["overflow"] == 0, f"{name} gate dropped {r['overflow']} "
              "active contacts")
    r = res["rk4"]
    actor_file, idx0, gate, jax_rew = RK4_GATE
    print(f"RK4 humanoid3d walk gate replay on {card}: reward "
          f"{r['reward']:.2f} over {r['length']} steps from frame {idx0} "
          f"(JAX replay {jax_rew}, gate {gate}), max contact overflow "
          f"{r['overflow']}; {r['launches']} kernel launches in 1000 steps")
    check(r["reward"] > gate, f"RK4 gate reward {r['reward']:.2f} <= {gate}")
    check(r["overflow"] == 0, f"RK4 gate dropped {r['overflow']} contacts")
    check(r["launches"] == 4 * r["steps"],
          f"RK4 gate: {r['launches']} launches in {r['steps']} steps")
    r = res["combined"]
    rews, ovs, lens = (np.asarray(r[k]) for k in (
        "rewards", "overflows", "lengths"))
    _, min_rew, min_len, jax_rew = COMBINED_GATE
    ok = (rews > min_rew) & (lens >= min_len) & (ovs == 0)
    print(f"combined gate replay on {card}: the recorded reset: reward "
          f"{rews[0]:.2f} over {lens[0]} steps, max contact overflow "
          f"{ovs[0]} (JAX replay {jax_rew} by the gate test's scan; bar: "
          f"reward > {min_rew}, length >= {min_len}, no overflow: "
          f"{'cleared' if ok[0] else 'not cleared'})")
    print(f"  {len(rews)} episodes from it, {len(rews) - 1} with the start "
          f"velocity moved by {COMBINED_NOISE} x N(0, 1): {int(ok.sum())} "
          f"clear the bar; median reward {np.median(rews):.2f} (min "
          f"{rews.min():.2f}, max {rews.max():.2f}); reward and length "
          f"without the overflow bar: "
          f"{int(((rews > min_rew) & (lens >= min_len)).sum())}; zero "
          f"overflow: {int((ovs == 0).sum())}; {r['launches']} kernel "
          "launches")
    print("  rewards: " + " ".join(f"{x:.1f}" for x in rews))
    check(np.median(rews) > min_rew,
          f"combined gate median reward {np.median(rews):.2f} <= {min_rew}")
    check(int(ok.sum()) >= COMBINED_MIN_PASS,
          f"{int(ok.sum())} of {len(rews)} combined gate episodes clear "
          "the bar")
    check(r["launches"] == r["steps"],
          f"combined gate: {r['launches']} launches in {r['steps']} steps")
    r = res["play_combined"]
    print(f"play_combined on {card}: reward {r['reward']:.2f} over "
          f"{r['steps']} steps, {r['injected']} fall(s) injected, recovery "
          f"cycles {r['cycles']}; {r['launches']} kernel launches for "
          f"{r['physics_steps']} physics steps; --video "
          + (f"{r['video_frames']} frames" if r["video_frames"] is not None
             else "left out (cv2 absent)"))
    check(r["path_ran"], "the fall -> to_getup -> getup path did not run")
    check(r["launches"] == r["physics_steps"],
          f"play_combined: {r['launches']} launches for "
          f"{r['physics_steps']} physics steps")
    r = res["sac"]
    actor_file, idx0, gate, jax_rew = SAC_GATE
    print(f"SAC humanoid3d walk gate replay on {card}: reward "
          f"{r['rewards'][0]:.2f} over {r['lengths'][0]} steps from frame "
          f"{idx0} (JAX replay {jax_rew}, gate {gate}), max contact "
          f"overflow {r['overflows'][0]}; beside it the actor distilled in "
          f"phase 11 (no gate): reward {r['rewards'][1]:.2f} over "
          f"{r['lengths'][1]} steps, max contact overflow "
          f"{r['overflows'][1]}; {r['launches']} kernel launches in "
          f"{r['steps']} steps of the pair")
    check(r["rewards"][0] > gate,
          f"SAC gate reward {r['rewards'][0]:.2f} <= {gate}")
    check(r["launches"] == r["steps"],
          f"SAC gate: {r['launches']} launches in {r['steps']} steps")
    r = res["play_extracted_run"]
    print(f"tools.play of run_extracted.npz on {card}: reward "
          f"{r['reward']:.2f} over {r['steps']} steps (gate 90), golden "
          f"test {'passed' if r['golden'] else 'not run'}; "
          f"{r['launches']} kernel launches")
    check(r["golden"] and r["reward"] > 90.0,
          f"play of the extracted run artifact: {r}")
    check(r["launches"] == r["steps"],
          f"play: {r['launches']} launches in {r['steps']} steps")
    r = rend = res["render"]
    print(f"render job on {card} (ray tracer on {r['threads']} host "
          f"thread(s), beside the replays): g++ {r['gxx_s']:.2f} s; "
          f"render_state card vs CPU FK, pixels differing: " + ", ".join(
              f"{k} {100 * v:.4f}%" for k, v in r["pixel_share"].items())
          + "; ms per frame: " + ", ".join(
              f"{k} {v:.2f}" for k, v in r["ms_per_frame"].items()))
    print(f"  viewer from the policy: {r['view_policy_launches']} launches "
          f"in {VIEW_FRAMES} frames; eval dashboard: "
          f"{r['dashboard_launches']} launches in {r['dashboard_len']} "
          f"steps, " + (f"{r['dashboard_ms_per_frame']:.1f} ms per "
                        "dashboard frame" if r["dashboard_ms_per_frame"]
                        else "no video (" + ", ".join(r["absent"])
                        + " absent)")
          + f"; play --video: {r['play_launches']} launches in "
          f"{r['play_steps']} steps, reward {r['play_reward']:.2f}, "
          f"{r['play_frames']} frames; validate_clip of the retargeted walk: "
          f"mean {r['validate_mean']:.4f} over {r['validate_steps']} steps, "
          f"{r['validate_launches']} launches")
    done(t0, "gate replays")

    # ---- 15. fine-tune recipes ----------------------------------------
    t0 = phase("fine-tune recipes")
    recipes = {name: finetune_recipe(card, dev, name) for name in RECIPES}
    done(t0, "fine-tune recipes")

    # ---- 16. contact-rich ---------------------------------------------
    t0 = phase("contact-rich")
    rich = contact_rich(card, dev, res, g1_sps)
    done(t0, "contact-rich")

    k128 = f"g1_k{CONTACT_RICH_K}"
    main_path = rich[f"getup_rollout_k{CONTACT_RICH_K}_b2048"]
    kernels = [{
        "name": "fused_solve",
        "route": "cuda",
        "source": "deepmimic_mujoco_tpu_torch/ops/csrc/fused_solve.cu",
        "replaces": "deepmimic_mujoco_tpu/ops/fused_solve.py:67",
        # this slice's main path: the G1 getup rollout at 128 contact
        # slots (the shared-memory plan, B 2048), held on its first step
        "launches": main_path["launches"],
        **{k: main_path[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")},
        "library_ms": None,
        "regs": info["h3d"]["regs"],
        "spills": spills,
        "smem_bytes": info["h3d"]["smem_bytes"],
        "blocks_per_sm": info["h3d"]["blocks_per_sm"],
        "shared_plan": {k: info[k128][k] for k in (
            "regs", "spill_bytes", "smem_bytes", "blocks_per_sm")},
        # every shared-memory instance, at the size phase 1 reads it
        "shared_instances": {
            label: {"plan": v["plan"].label, **{k: v[k] for k in (
                "regs", "spill_bytes", "smem_bytes", "blocks_per_sm")}}
            for label, v in info.items() if v["plan"].shared},
        "paths": {
            **{k: {"library_ms": None, **v} for k, v in rich.items()},
            "finetune_f2": {**recipes["f2"], "library_ms": None},
            "finetune_r5b": {**recipes["r5b"], "library_ms": None},
            "ppo_dp": {**dp, "library_ms": None},
            "sac_h3d_b256": {"launches": sum(sac_launches), **sac_k},
            "sac_train": {"launches": sum(sac_launches),
                          "launches_per_iteration": sac_launches,
                          "evaluator_launches": sac_eval, **sac_numbers},
            "sac_distill": {"launches": distill_launches, **distill_k,
                            "distilled_replay_reward":
                                res["sac"]["rewards"][1]},
            "sac_gate": {"launches": res["sac"]["launches"],
                         "reward": res["sac"]["rewards"][0]},
            "play_extracted": {
                "launches": res["play_extracted_run"]["launches"],
                "reward": res["play_extracted_run"]["reward"],
                "held_at": "g1_b1"},
            # the kernel at B 1, held and timed in phase 12 once per plan;
            # each path at B 1 names the hold of its plan
            **b1,
            "eval_dashboard": {"launches": rend["dashboard_launches"],
                               "steps": rend["dashboard_len"],
                               "ms_per_frame":
                                   rend["dashboard_ms_per_frame"],
                               "held_at": "h3d_b1"},
            "view_policy": {"launches": rend["view_policy_launches"],
                            "frames": VIEW_FRAMES, "held_at": "h3d_b1"},
            "play_video": {"launches": rend["play_launches"],
                           "steps": rend["play_steps"],
                           "frames": rend["play_frames"],
                           "reward": rend["play_reward"],
                           "held_at": "g1_b1"},
            "validate_clip": {"launches": rend["validate_launches"],
                              "steps": rend["validate_steps"],
                              "mean_reward": rend["validate_mean"]},
            "throughput_sweep": {str(b): sps for b, sps in sweep},
            "h3d_walk_b2048": {"launches": h3d_launches, **h3d_k,
                               "regs": info["h3d"]["regs"],
                               "blocks_per_sm": info["h3d"]["blocks_per_sm"]},
            "g1_walk_b2048": {"launches": g1_launches, **g1_k},
            "ppo_g1_walk": {"launches": sum(ppo_launches),
                            "launches_per_iteration": ppo_launches,
                            "evaluator_launches": eval_launches},
            "combined_b2048": {"launches": comb_launches, **comb_k,
                               "handoff_count": handoff_count,
                               "regs": info["g1"]["regs"],
                               "smem_bytes": info["g1"]["smem_bytes"],
                               "blocks_per_sm": info["g1"]["blocks_per_sm"]},
            "combined_gate": {"launches": res["combined"]["launches"],
                              "episodes": len(rews),
                              "cleared": int(ok.sum()),
                              "median_reward": float(np.median(rews)),
                              "recorded_reset_reward": float(rews[0])},
            "play_combined": {"launches": res["play_combined"]["launches"],
                              "cycles": res["play_combined"]["cycles"]},
            "rk4_h3d_b2048": {"launches": rk4_launches,
                              "launches_per_step": 4, **rk4_k},
            "rk4_gate": {"launches": res["rk4"]["launches"]},
            "ppo_combined": {"launches": sum(comb_ppo),
                             "launches_per_iteration": comb_ppo,
                             "evaluator_launches": comb_eval,
                             "handoff_count": comb_handoff},
        },
    }]
    print(f"total: {time.perf_counter() - t_all:.2f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def data_parallel_main():
    """``chip_smoke.py --data-parallel``: the build and phase 13 alone
    (on a machine with several cards, with its world of every card over
    NCCL), then the phase's numbers as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from deepmimic_mujoco_tpu_torch.ops import fused_solve as fs
    from deepmimic_mujoco_tpu_torch.utils.device import fp32_physics

    fp32_physics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    cards = [c.strip() for c in smi.stdout.strip().splitlines()]
    print(f"cards: {'; '.join(cards)}")
    fs.build_all(names=("fused_solve",))
    t0 = phase("data parallel")
    dp = data_parallel(cards[0], torch.device("cuda"))
    done(t0, "data parallel")
    print(json.dumps(dp))
    return 0


def contact_rich_main():
    """``chip_smoke.py --contact-rich``: the build (phase 1) and phase 16
    alone, with its gate replay and the same actor at 24 slots run as
    replay jobs first, then the phase's numbers as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from deepmimic_mujoco_tpu_torch.utils.device import fp32_physics

    fp32_physics()
    card = card_line()
    print(f"card: {card}")
    t0 = phase("build")
    build_kernels()
    done(t0, "build")
    t0 = phase("contact-rich")
    res = run_replays(card, ("g1_getup", *GATES_K128), REPLAY_TIMEOUT)
    rich = contact_rich(card, torch.device("cuda"), res)
    done(t0, "contact-rich")
    print(json.dumps(rich))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] == "--data-parallel":
        sys.exit(data_parallel_main())
    if len(sys.argv) == 2 and sys.argv[1] == "--contact-rich":
        sys.exit(contact_rich_main())
    if len(sys.argv) == 3 and sys.argv[1] == "--replay":
        sys.path.insert(0, REPO)
        replay_job(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
