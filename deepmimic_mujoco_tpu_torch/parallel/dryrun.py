"""Multi-rank dry run: one full PPO iteration sharded over a process group.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
the env batch split over ``n`` ranks, params replicated, the gradient
average and every other read across envs made a collective. Tiny shapes.

    python -m deepmimic_mujoco_tpu_torch.parallel.dryrun --n-devices 4 \\
        [--device cpu] [--backend gloo]

On the card (the default) every rank has a card of its own and the
ranks talk over NCCL; ``--backend gloo`` lets the ranks share one card;
``--device cpu`` runs gloo on CPU tensors.

``launch`` is the spawner under it: it starts one process per rank
(``torch.multiprocessing``, spawned), joins them in one group through a
``file://`` store in a temporary directory (no port to collide on) and
returns each rank's result. A rank that raises fails the launch, and
the other ranks are stopped.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deepmimic_mujoco_tpu_torch.parallel.mesh import init_group, pick_backend
from deepmimic_mujoco_tpu_torch.utils.device import resolve_device


def _rank_main(rank, world, init_method, device, backend, fn, args, out_dir):
    if resolve_device(device).type == "cpu":
        torch.set_num_threads(1)     # the ranks are the parallelism
    mesh = init_group(rank, world, init_method, device, backend)
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, args=(), device="cuda",
           backend: Optional[str] = None) -> list:
    """``fn(mesh, *args)`` on ``n_ranks`` spawned ranks; their results
    (saved with ``torch.save``) in rank order. ``fn`` must be importable
    by name from a module whose import is cheap (each rank imports it).
    On the card the kernel library is built here, before the spawn, so
    that no rank builds it."""
    pick_backend(device, n_ranks, backend)     # raises before any spawn
    if resolve_device(device).type == "cuda":
        from deepmimic_mujoco_tpu_torch.ops import fused_solve

        fused_solve.build_all(names=("fused_solve",))
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        mp.spawn(_rank_main, nprocs=n_ranks, join=True, args=(
            n_ranks, init_method, str(device), backend, fn, tuple(args),
            tmp))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]


def _dryrun_rank(mesh):
    from deepmimic_mujoco_tpu_torch.envs import DPEnv
    from deepmimic_mujoco_tpu_torch.parallel.mesh import shard_train_state
    from deepmimic_mujoco_tpu_torch.rl.ppo import PPO, PPOConfig

    n = mesh.world
    env = DPEnv(motion="walk", robot="humanoid3d", iterations=10,
                device=mesh.device)
    cfg = PPOConfig(n_envs=2 * n, horizon=4, minibatch_size=4 * n,
                    epochs=2, net_arch=(32, 32))
    ppo = PPO(env, cfg)
    ts = shard_train_state(ppo.init(seed=0), mesh)
    ts, stats = ppo.train_iter(ts)
    # sanity: env states stayed split over the ranks
    local = {x.shape[0] for x in ts.env_states}
    if local != {cfg.n_envs // n} or ts.last_obs.shape[0] != cfg.n_envs // n:
        raise RuntimeError(f"env states not split over {n} ranks: {local}")
    reward = float(stats.mean_reward)
    if mesh.rank == 0:
        print(f"dryrun_multichip({n}) OK: mean_reward={reward:.4f}",
              flush=True)
    return reward


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: Optional[str] = None) -> float:
    """One PPO iteration of humanoid3d walk sharded over ``n_devices``
    ranks (2 envs and 4 minibatch samples a rank); rank 0 prints the
    OK line. Returns the iteration's mean reward."""
    return launch(_dryrun_rank, n_devices, device=device,
                  backend=backend)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-devices", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, args.backend)


if __name__ == "__main__":
    main()
