"""Data parallelism: the env batch split over a torch.distributed group.

The port of the JAX package's ``parallel/mesh.py``. There the env batch
is an array axis sharded over a one-axis ``Mesh("data")``, parameters
are replicated, and XLA inserts the collectives. Here each rank is a
process that holds a contiguous slice of the env batch and a replica of
everything else, and the trainer (``rl/ppo.py``) makes every read across
envs an explicit collective, so that a sharded iteration computes what
the unsharded one does.

- ``init_group`` joins the process group and picks the backend: NCCL
  when every rank has a card of its own, gloo for CPU tensors, gloo on a
  shared card only when the caller asks for it. Any other mismatch
  raises; nothing moves to the CPU or to another backend unasked.
- ``make_mesh`` describes the joined group: world size, rank, this
  rank's device, the group and the axis name.
- ``data_sharding(mesh)`` keeps rank r's slice ``[r n/W, (r+1) n/W)`` of
  a leading env axis (``shard``) and puts the slices back together in
  rank order (``gather``).
- ``replicated(mesh)`` broadcasts from rank 0 (``place``) and checks
  that every rank holds the same values (``check``).
- ``shard_train_state`` places a PPO ``TrainState`` as the JAX package
  does: env-indexed leaves sliced, the rest replicated.

The mesh counts its collectives (``Mesh.counts``): calls by kind and the
bytes each rank sends.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from deepmimic_mujoco_tpu_torch.utils.device import resolve_device

# a collective that waits this long for a peer fails the run
TIMEOUT_S = 600


def pick_backend(device, world: int, backend: Optional[str] = None) -> str:
    """The backend for ``world`` ranks on ``device``: gloo for the CPU,
    NCCL on the card when there is a card per rank, gloo on the card
    only when ``backend="gloo"`` is asked for. Raises on any mismatch."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} cannot run on CPU "
                             "tensors; use gloo")
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"no data-parallel backend for device {dev}")
    n_cards = torch.cuda.device_count()
    if backend == "gloo":
        return "gloo"
    if backend not in (None, "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if n_cards < world:
        raise RuntimeError(
            f"{world} ranks over NCCL need {world} cards, and "
            f"{n_cards} are present (NCCL refuses two ranks on one "
            "device); pass backend='gloo' to share a card")
    return "nccl"


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or card ``rank`` modulo the
    number of cards."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_group(rank: int, world: int, init_method: str, device="cuda",
               backend: Optional[str] = None) -> "Mesh":
    """Join the default process group as ``rank`` of ``world`` (a
    ``file://`` or ``tcp://`` ``init_method``) on the backend
    ``pick_backend`` gives, and return its mesh."""
    backend = pick_backend(device, world, backend)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return make_mesh(world, device=dev)


@dataclasses.dataclass
class Mesh:
    """One rank's view of a one-axis data mesh."""
    world: int
    rank: int
    device: torch.device
    backend: str
    group: Any = None           # the process group (None: the default)
    axis: str = "data"
    counts: Dict[str, int] = dataclasses.field(default_factory=lambda: {
        "all_reduce": 0, "all_gather": 0, "broadcast": 0, "barrier": 0,
        "bytes": 0})

    def _on_wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the backend can send it: NCCL sends card tensors
        only, so a CPU tensor (a generator's state) goes by the card."""
        if self.backend == "nccl" and x.device.type != "cuda":
            return x.to(self.device)
        return x.contiguous()

    def _count(self, kind: str, x: torch.Tensor):
        self.counts[kind] += 1
        self.counts["bytes"] += x.numel() * x.element_size()

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``x`` reduced over the ranks (a new tensor; every rank gets
        the same values)."""
        y = self._on_wire(x).clone()
        self._count("all_reduce", y)
        dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.device)

    def all_gather(self, x: torch.Tensor) -> list:
        """Every rank's ``x``, in rank order."""
        y = self._on_wire(x)
        parts = [torch.empty_like(y) for _ in range(self.world)]
        self._count("all_gather", y)
        dist.all_gather(parts, y, group=self.group)
        return [p.to(x.device) for p in parts]

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x``, written into ``x`` on every rank."""
        y = self._on_wire(x)
        self._count("broadcast", y)
        dist.broadcast(y, src=0, group=self.group)
        if y is not x:
            x.copy_(y)
        return x

    def barrier(self):
        """Wait until every rank has reached this call."""
        self.counts["barrier"] += 1
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device=None) -> Mesh:
    """The mesh of the joined default group. ``n_devices``, when given,
    must be the world size; ``device`` defaults to the current card
    under NCCL and to the CPU under gloo (pass the card to run gloo on
    one)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: join one with init_group "
                           "(or torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} over a group of {world}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = resolve_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group holds card tensors; "
                         f"device {device} is not a card")
    return Mesh(world=world, rank=rank, device=device, backend=backend,
                axis=axis)


class DataSharding:
    """The leading (env) dim split over the mesh: rank r holds rows
    ``[r n/W, (r+1) n/W)``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.world, self.rank = mesh.world, mesh.rank

    def shard(self, x):
        """This rank's rows of ``x``."""
        n = x.shape[0]
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} "
                             "ranks")
        k = n // self.world
        return x[self.rank * k:(self.rank + 1) * k]

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The rank slices of ``x`` concatenated along ``dim`` in rank
        order: the global tensor whose ``shard`` each rank holds."""
        return torch.cat(self.mesh.all_gather(x), dim)


class Replicated:
    """Values every rank holds alike: ``place`` broadcasts rank 0's,
    ``check`` says whether every rank holds rank 0's bit for bit."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def place(self, x):
        if torch.is_tensor(x):
            return self.mesh.broadcast(x)
        if isinstance(x, (int, float)):
            t = self.mesh.broadcast(torch.tensor(float(x),
                                                 dtype=torch.float64))
            return type(x)(t.item())
        return x

    def check(self, x: torch.Tensor) -> bool:
        ref = self.mesh.broadcast(x.detach().clone())
        differs = self.mesh.all_reduce(torch.tensor(
            [0 if torch.equal(ref, x) else 1], device=self.mesh.device))
        return int(differs) == 0


def data_sharding(mesh: Mesh) -> DataSharding:
    """Shard the leading (env/batch) dim across the mesh."""
    return DataSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def tree_map(fn, x):
    """``fn`` over the leaves of nested NamedTuples (an env state, the
    handoff buffer)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[tree_map(fn, v) for v in x])
    return fn(x)


def shard_train_state(ts, mesh: Mesh):
    """Place a PPO ``TrainState`` (built for the global env batch) on the
    mesh, in place, and return it: every leaf of ``env_states`` whose
    leading dim is the env count, ``last_obs``, ``ep_return`` and
    ``ep_length`` are broadcast from rank 0 and sliced to this rank's
    envs; the net, the optimizer state, the generators, ``global_step``,
    ``lr_scale`` and the handoff buffer are broadcast from rank 0. The
    mesh is stored on the state, so ``PPO.train_iter`` runs sharded."""
    n_envs = ts.last_obs.shape[0]
    if n_envs % mesh.world:
        raise ValueError(f"n_envs {n_envs} does not split over "
                         f"{mesh.world} ranks")
    if ts.last_obs.device != mesh.device:
        raise ValueError(f"the train state lies on {ts.last_obs.device}, "
                         f"the mesh's rank on {mesh.device}")
    data, rep = data_sharding(mesh), replicated(mesh)

    def place(x):
        if torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == n_envs:
            return data.shard(rep.place(x)).clone()
        return rep.place(x)

    ts.env_states = tree_map(place, ts.env_states)
    ts.last_obs, ts.ep_return, ts.ep_length = (
        data.shard(rep.place(x)).clone()
        for x in (ts.last_obs, ts.ep_return, ts.ep_length))
    with torch.no_grad():
        for t in (*ts.net.parameters(), *ts.net.buffers(), *ts.opt.mu,
                  *ts.opt.nu):
            rep.place(t)
    ts.opt.count = rep.place(ts.opt.count)
    for g in ts.gens.values():
        g.set_state(rep.place(g.get_state()))
    ts.global_step = rep.place(ts.global_step)
    ts.lr_scale = rep.place(ts.lr_scale)
    if ts.handoff_buf is not None:
        ts.handoff_buf = tree_map(rep.place, ts.handoff_buf)
    ts.mesh = mesh
    return ts
