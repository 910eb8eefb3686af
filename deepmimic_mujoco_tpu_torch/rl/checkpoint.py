"""Checkpoints: the full train state, params only, and the actor npz.

``save``/``restore`` write and read everything a PPO run needs to resume
exactly: the params, the Adam state (with its update count), the env
states, the generators' states, ``global_step``, ``lr_scale`` and the
combined env's handoff buffer, with ``torch.save``. A data-parallel
state (``parallel.shard_train_state``) is saved as the global batch, as
the JAX package's ``save`` writes it: every rank gathers its env rows,
rank 0 alone writes, and the ranks meet at a barrier before ``save``
returns. ``restore`` always returns the global state; to go on sharded,
place it again with ``shard_train_state``.
``save_params``/``restore_params`` keep a params-only state dict
(deployment, eval, warm starts); ``save_actor_npz`` and
``save_sac_actor_npz`` write a PPO or SAC actor as npz. The JAX
package's orbax checkpoints are not read here (only tensorstore reads
them): ``tools/export_params.py``, a script beside the JAX package,
turns a params directory into the port's params file
(``rl/convert.py:params_from_flax``), and the committed ones reach the
port as such files and as actor npz files.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from deepmimic_mujoco_tpu_torch.rl.convert import (
    actor_npz_arrays, sac_actor_npz_arrays,
)


def _path(path: str) -> str:
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def _global_env_leaves(ts):
    """``ts``'s env-indexed leaves (every ``env_states`` leaf whose
    leading dim is the env count, ``last_obs``, ``ep_return`` and
    ``ep_length``) over the global batch: gathered from every rank in
    rank order when ``ts`` is sharded, as they are otherwise."""
    fields = (ts.env_states, ts.last_obs, ts.ep_return, ts.ep_length)
    if ts.mesh is None:
        return fields
    from deepmimic_mujoco_tpu_torch.parallel.mesh import (
        data_sharding, tree_map,
    )

    data, n = data_sharding(ts.mesh), ts.last_obs.shape[0]
    gather = lambda x: (data.gather(x) if torch.is_tensor(x) and x.dim() >= 1
                        and x.shape[0] == n else x)
    return tuple(tree_map(gather, x) for x in fields)


def save(path: str, ts) -> str:
    """Write the train state ``ts`` (``ppo.TrainState``) to ``path``; a
    sharded one as its global batch, from rank 0 (every rank must
    call)."""
    path = os.path.abspath(os.path.expanduser(path))
    env_states, last_obs, ep_return, ep_length = _global_env_leaves(ts)
    if ts.mesh is not None and ts.mesh.rank != 0:
        ts.mesh.barrier()
        return path
    torch.save({
        "net": ts.net.state_dict(), "opt": ts.opt.state_dict(),
        "env_states": dict(env_states._asdict()),
        "last_obs": last_obs,
        "gens": {k: g.get_state() for k, g in ts.gens.items()},
        "global_step": ts.global_step, "ep_return": ep_return,
        "ep_length": ep_length, "lr_scale": ts.lr_scale,
        "handoff_buf": (None if ts.handoff_buf is None
                        else dict(ts.handoff_buf._asdict()))}, _path(path))
    if ts.mesh is not None:
        ts.mesh.barrier()
    return path


def restore(path: str, template):
    """Load the train state at ``path`` into ``template`` (a fresh
    ``PPO.init`` state of the same configuration, whose net, optimizer
    and generators receive it) and return it: the global state, unsharded
    (``mesh`` None)."""
    data = torch.load(os.path.expanduser(path), map_location="cpu",
                      weights_only=True)
    dev = template.last_obs.device
    template.net.load_state_dict(data["net"])
    template.opt.load_state_dict(data["opt"])
    template.env_states = type(template.env_states)(
        **{k: v.to(dev) for k, v in data["env_states"].items()})
    template.last_obs = data["last_obs"].to(dev)
    for k, g in template.gens.items():
        g.set_state(data["gens"][k])
    template.global_step = int(data["global_step"])
    template.ep_return = data["ep_return"].to(dev)
    template.ep_length = data["ep_length"].to(dev)
    template.lr_scale = float(data["lr_scale"])
    if data.get("handoff_buf") is not None:
        template.handoff_buf = type(template.handoff_buf)(
            **{k: v.to(dev) for k, v in data["handoff_buf"].items()})
    template.mesh = None
    return template


def save_params(path: str, net) -> str:
    """Params-only artifact (deployment / eval)."""
    path = _path(path)
    torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()},
               path)
    return path


def restore_params(path: str, template=None) -> dict:
    """The state dict at ``path``; with a ``template`` state dict, on its
    tensors' devices."""
    sd = torch.load(os.path.expanduser(path), map_location="cpu",
                    weights_only=True)
    if template is not None:
        sd = {k: v.to(template[k].device) for k, v in sd.items()}
    return sd


def save_actor_npz(path: str, net) -> str:
    """The actor in the ``w0..bN`` + ``log_std`` npz format."""
    path = _path(path)
    np.savez(path, **actor_npz_arrays(net))
    return path


def save_sac_actor_npz(path: str, actor) -> str:
    """A SAC ``Actor`` in its npz format (``rl/convert.py``)."""
    path = _path(path if path.endswith(".npz") else path + ".npz")
    np.savez(path, **sac_actor_npz_arrays(actor))
    return path


def adapt_params(params: dict, template: dict) -> dict:
    """Adapt a state dict to a template with a WIDER observation input.

    Cross-env warm starts (a DPEnv checkpoint into a combined-env
    trainer) differ only in the first layer's input width: the combined
    env appends player-action dims to the END of the obs vector, so the
    extra input columns of the first layers' weights (torch's (out, in)
    layout) are zero: the new obs dims contribute nothing and the
    pretrained mapping is kept exactly. Any other mismatch is an error.
    """
    if set(params) != set(template):
        raise ValueError("params tree structure mismatch")
    out = {}
    for k, p in params.items():
        t = template[k]
        if p.shape == t.shape:
            out[k] = p
        elif (p.dim() == 2 and t.dim() == 2 and p.shape[0] == t.shape[0]
              and t.shape[1] > p.shape[1]):
            out[k] = torch.cat([p, p.new_zeros(p.shape[0],
                                               t.shape[1] - p.shape[1])], 1)
        else:
            raise ValueError(f"cannot adapt param {k} of shape "
                             f"{tuple(p.shape)} to {tuple(t.shape)}")
    return out
