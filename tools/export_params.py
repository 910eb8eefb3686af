"""Export a params directory of the JAX package for the PyTorch port (a
JAX-side script, not part of the port).

    JAX_PLATFORMS=cpu python tools/export_params.py SRC OUT \\
        [--env deep_mimic_mujoco|dp_combined_env] [--motion walk] \\
        [--robot unitree_g1] [--kind torque|pd] [--net-arch 256,128]
    JAX_PLATFORMS=cpu python tools/export_params.py --all

SRC is an orbax params directory the JAX package wrote (an evaluation's
``*_best``, ``rl/checkpoint.py:save_params``). It is restored with the
JAX package's ``rl/checkpoint.py:restore_params`` against the template
of ``rl/networks.py:make_policy(kind, env, net_arch)``, the env fixing
the observation width, and written to OUT as the port's params file
(``rl/convert.py:params_from_flax``, ``rl/checkpoint.py:save_params``),
which the port's ``rl/train.py --init-params``, ``tools/play.py`` and
``tools/play_combined.py`` read. A PD net (``--kind pd``) has the same
parameters as a torque one: its gains are constants of the env, not
parameters. A directory whose shapes differ from the template's is
refused.

``--all`` writes the files the card needs into
``deepmimic_mujoco_tpu_torch/data/`` (the chip's copy of the repo leaves
``runs/`` out): the warm starts of the recorded fine-tune recipes,
``combined_r4_best_params.pt`` (``tools/train_queue_r5b.sh``) and
``g1_walk_best_params.pt`` (``tools/train_queue_r5c.sh``, leg F2).
"""
import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "deepmimic_mujoco_tpu_torch", "data")

# (source directory, output file, --env, --motion, --robot, --kind)
ALL = (
    ("runs/combined_r4_best", "combined_r4_best_params.pt",
     "dp_combined_env", "walk", "unitree_g1", "torque"),
    ("runs/walk_test20260817-1741_21_videos/walk_test20260817-1741_21_best",
     "g1_walk_best_params.pt", "deep_mimic_mujoco", "walk", "unitree_g1",
     "torque"),
)


def make_env(env="deep_mimic_mujoco", motion="walk", robot="unitree_g1"):
    """The JAX package's env of the training CLI's ``--env``."""
    from deepmimic_mujoco_tpu.envs import DPCombinedEnv, DPEnv

    if env == "dp_combined_env":
        return DPCombinedEnv()
    if env != "deep_mimic_mujoco":
        raise ValueError(f"unknown env {env!r}")
    return DPEnv(motion=motion, robot=robot)


def export(src, out, env, kind="torque", net_arch=(256, 128)) -> dict:
    """Restore ``src`` against ``kind``'s template on ``env`` and write
    the port's params file ``out``. Returns the port's state dict."""
    import jax
    import jax.numpy as jnp

    from deepmimic_mujoco_tpu.rl import networks
    from deepmimic_mujoco_tpu.rl.checkpoint import restore_params

    from deepmimic_mujoco_tpu_torch.rl.checkpoint import save_params
    from deepmimic_mujoco_tpu_torch.rl.convert import params_from_flax
    from deepmimic_mujoco_tpu_torch.rl.networks import ActorCritic

    net = networks.make_policy(kind, env, net_arch=tuple(net_arch))
    tmpl = net.init(jax.random.PRNGKey(0),
                    jnp.zeros((env.obs_size,), jnp.float32))
    params = restore_params(os.path.abspath(src), tmpl)
    shapes = lambda t: jax.tree.map(lambda x: np.shape(x), t)
    if shapes(params) != shapes(tmpl):
        raise ValueError(f"{src} does not hold a {kind} net of arch "
                         f"{tuple(net_arch)} on obs width {env.obs_size}: "
                         f"{shapes(params)} against {shapes(tmpl)}")
    sd = params_from_flax(jax.tree.map(np.asarray, params), net_arch)
    # the state dict of a PD net is an ActorCritic's (its gains are not
    # parameters), so loading it checks every name and shape
    port = ActorCritic(env.obs_size, env.action_size,
                       net_arch=tuple(net_arch), device="cpu")
    port.load_state_dict(sd)
    save_params(out, port)
    return sd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", nargs="?")
    p.add_argument("out", nargs="?")
    p.add_argument("--all", action="store_true",
                   help="write the recipes' warm starts into the port's "
                        "data directory")
    p.add_argument("--env", default="deep_mimic_mujoco",
                   choices=["deep_mimic_mujoco", "dp_combined_env"])
    p.add_argument("--motion", default="walk")
    p.add_argument("--robot", default="unitree_g1")
    p.add_argument("--kind", default="torque", choices=["torque", "pd"])
    p.add_argument("--net-arch", default="256,128")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    arch = tuple(int(w) for w in args.net_arch.split(","))
    if args.all:
        jobs = [(os.path.join(REPO, src), os.path.join(DATA, out), e, m, r,
                 k) for src, out, e, m, r, k in ALL]
    elif args.src and args.out:
        jobs = [(args.src, args.out, args.env, args.motion, args.robot,
                 args.kind)]
    else:
        p.error("give SRC and OUT, or --all")
    for src, out, env, motion, robot, kind in jobs:
        e = make_env(env, motion, robot)
        sd = export(src, out, e, kind, arch)
        print(f"{src} ({kind}, arch {arch}, obs {e.obs_size}, action "
              f"{e.action_size}) -> {out}: {len(sd)} tensors, "
              f"{os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
