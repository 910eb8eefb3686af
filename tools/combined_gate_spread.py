"""Spread of the combined-env gate replay under tiny start perturbations.

The combined gate (tests/test_checkpoint_gates.py:test_combined_env_gate)
replays ``runs/combined_r5_best`` for 2000 steps from the reset the JAX
package draws from PRNGKey(0) and requires reward > 100 over >= 1900
steps. The policy falls in some of its episodes, and whether and when it
falls is sensitive to rounding: this script replays the same start
``--n`` times at once, the first episode unchanged and the others with
the start velocity moved by ``--noise`` times a seeded standard normal
(numpy RandomState(0)), and prints each episode's reward, length and (in
the port) largest contact overflow, with the count that clears the bar.

    JAX_PLATFORMS=cpu python tools/combined_gate_spread.py [--port-cpu]

``--port-cpu`` replays the same starts with the PyTorch port on the CPU
too (its plain solve). ``chip_smoke.py`` phase 9 replays them on the card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2000
MIN_REW, MIN_LEN = 100.0, 1900


def perturbed_qvel(qvel0, n, noise):
    """(n, nv) start velocities: row 0 unchanged, the others moved by
    ``noise`` times a RandomState(0) standard normal (float32)."""
    qvel0 = np.asarray(qvel0, np.float32)
    d = (np.random.RandomState(0).randn(n - 1, qvel0.shape[0])
         * noise).astype(np.float32)
    return np.concatenate([qvel0[None], qvel0[None] + d])


def summary(name, rew, length, ov=None):
    rew, length = np.asarray(rew, np.float64), np.asarray(length)
    ok = (rew > MIN_REW) & (length >= MIN_LEN)
    if ov is not None:
        ok_ov = ok & (np.asarray(ov) == 0)
    for k in range(len(rew)):
        extra = "" if ov is None else f" overflow {int(ov[k])}"
        print(f"{name} episode {k}: reward {rew[k]:.2f} length "
              f"{int(length[k])}{extra}")
    line = (f"{name}: {int(ok.sum())} of {len(rew)} clear reward > "
            f"{MIN_REW} and length >= {MIN_LEN}; median reward "
            f"{np.median(rew):.2f}, min {rew.min():.2f}, max {rew.max():.2f}")
    if ov is not None:
        line += f"; {int(ok_ov.sum())} of them also with zero overflow"
    print(line, flush=True)


def jax_spread(n, noise):
    import jax
    import jax.numpy as jnp

    from deepmimic_mujoco_tpu.envs import DPCombinedEnv
    from deepmimic_mujoco_tpu.rl import networks
    from deepmimic_mujoco_tpu.rl.checkpoint import restore_params

    env = DPCombinedEnv()
    net = networks.ActorCritic(env.action_size)
    params = restore_params(
        os.path.join(REPO, "runs", "combined_r5_best"),
        net.init(jax.random.PRNGKey(0), jnp.zeros(env.obs_size)))
    state0, obs0 = jax.jit(env.reset)(jax.random.PRNGKey(0))
    qvels = perturbed_qvel(state0.qvel, n, noise)

    def one(qvel):
        # the gate's clean episode (tests/test_checkpoint_gates.py)
        def body(carry, _):
            state, obs, alive = carry
            mean = net.apply(params, obs)[0]
            nstate, out = env.step(state, mean)
            r = out.reward * alive.astype(out.reward.dtype)
            state = jax.tree.map(lambda a, b: jnp.where(alive, a, b),
                                 nstate, state)
            obs = jnp.where(alive, out.obs, obs)
            return (state, obs, alive & ~out.done), (r, alive)

        _, (rews, alives) = jax.lax.scan(
            body, (state0._replace(qvel=qvel), obs0, jnp.ones((), bool)),
            None, length=STEPS)
        return rews.sum(), alives.sum()

    t = time.time()
    rew, length = jax.jit(jax.vmap(one))(jnp.asarray(qvels))
    print(f"JAX package, {n} episodes vmapped on the CPU: "
          f"{time.time() - t:.1f} s")
    summary("JAX", np.asarray(rew), np.asarray(length))


def port_spread(n, noise):
    import torch

    from deepmimic_mujoco_tpu_torch.envs import DPCombinedEnv
    from deepmimic_mujoco_tpu_torch.rl.convert import actor_from_npz

    data = os.path.join(REPO, "deepmimic_mujoco_tpu_torch", "data")
    env = DPCombinedEnv(device="cpu")
    start = np.load(os.path.join(data, "combined_gate_start.npz"))
    full = lambda k: np.full(n, start[k])
    state, obs = env.reset_to(
        np.tile(start["qpos"][None], (n, 1)),
        perturbed_qvel(start["qvel"], n, noise), full("motion_id"),
        full("n_steps"), full("player_action"))
    actor = actor_from_npz(os.path.join(data, "combined_r5_best_actor.npz"),
                           device="cpu")
    alive = torch.ones(n, dtype=torch.bool)
    rew = torch.zeros(n)
    length = torch.zeros(n, dtype=torch.int64)
    ov = torch.zeros(n, dtype=torch.int64)
    t = time.time()
    with torch.no_grad():
        for _ in range(STEPS):
            state, out = env.step(state, actor(obs)[0])
            rew += out.reward * alive
            length += alive
            ov = torch.maximum(ov, out.contact_overflow * alive)
            alive &= ~out.done
            obs = out.obs
    print(f"port, {n} episodes batched on the CPU: {time.time() - t:.1f} s")
    summary("port (CPU)", rew.numpy(), length.numpy(), ov.numpy())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--noise", type=float, default=1e-5)
    p.add_argument("--port-cpu", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    jax_spread(args.n, args.noise)
    if args.port_cpu:
        port_spread(args.n, args.noise)


if __name__ == "__main__":
    main()
