"""The Euler env step replayed as two CUDA graphs around the fused solve.

Run op by op, a batched ``step_auto_reset`` on the card issues ~2,300
launches (forward kinematics, ``com_pos``, collision with top-K, CRBA,
RNE, the constraint rows, integration, obs, reward, done, resets) for
~5-10 ms of device work, so the host's launch cost sets the step's time.
``StepGraphs`` captures the step once per key and replays it:

    copy the arguments into the graphs' static inputs
    graph A     the step up to the solve: every input of the solve
    the solve   ``physics/solver.py:solve``, called from Python: one
                kernel launch, its counters and span, and any wrapper of
                ``solver.fused_solve_parts`` see every step; ``active``
                is a fresh tensor each call (an eager ``.to(dtype)``)
    copy qacc, qfrc and lam into graph B's static inputs
    graph B     the warm-start scatter, the integration, obs, reward,
                done, the guards and the auto-reset, its outputs packed
                into one buffer per dtype
    clone them  the returned tensors are the caller's, so a caller may
                keep step n's outputs past step n+1, pass them back or
                save them

The key: the shapes and dtypes of the tensor arguments (the batch, and
whether a handoff buffer or forced draws are given), the generator and
the data-parallel shard. A and B share one memory pool and are captured
on a side stream. The first ``WARMUP_CALLS`` calls of a key run the
eager step on that stream; the next one captures, outside any profiler
(under one the step runs eager until the profiler stops). The step's
generator is registered with graph B, so a replay's draws and the
generator's later state are the eager step's. A replay under a profiler
or ``tracing.collect()`` records ``env.step`` and ``engine.solve`` (the
stages' spans only at capture) and counts ``env.graph_replays``; an
eager call counts ``env.graph_eager``.

Where it applies: a CUDA device, the Euler integrator, and no argument
that requires grad while grad is on. RK4 (four solves a step), the CPU
and ``step(..., force_state=...)`` run eager; a failed capture raises.
A captured step reads the env's settings (its config) as they were at
capture.
"""
from __future__ import annotations

import torch

from deepmimic_mujoco_tpu_torch.models.physics_model import RK4
from deepmimic_mujoco_tpu_torch.physics.solver import SolveResult
from deepmimic_mujoco_tpu_torch.utils import tracing

WARMUP_CALLS = 2     # eager calls of a key before it is captured
_ALIGN = 16          # bytes: each output's offset in its packed buffer


def _flatten(x, leaves: list, sig: list):
    """The tensors of a nest of tuples (``leaves``) and its structure
    with each tensor's shape and dtype (``sig``)."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        sig.append((x.shape, x.dtype))
    elif isinstance(x, tuple):
        sig.append(len(x))
        for v in x:
            _flatten(v, leaves, sig)
    else:
        sig.append(x)


def _rebuild(like, it):
    """``like`` with its tensors replaced by the next ones of ``it``."""
    if isinstance(like, torch.Tensor):
        return next(it)
    if isinstance(like, tuple):
        vals = [_rebuild(v, it) for v in like]
        return type(like)(*vals) if hasattr(like, "_fields") else tuple(vals)
    return like


def _shard_key(shard):
    return None if shard is None else (shard.world, shard.rank)


class _Packed:
    """Tensors laid out in one buffer per dtype, so the step's outputs
    leave a replay in one copy per dtype. The views of one buffer share
    its dtype (``torch.save`` refuses views of one storage as two
    types)."""

    def __init__(self, like, device):
        self.layout, ends = [], {}
        for x in like:
            o, n = ends.get(x.dtype, 0), x.numel()
            align = max(1, _ALIGN // x.element_size())
            self.layout.append((x.dtype, o, n, x.shape))
            ends[x.dtype] = o + -(-n // align) * align
        self.bufs = {dt: torch.empty(n, dtype=dt, device=device)
                     for dt, n in ends.items()}

    def views(self, bufs) -> list:
        return [bufs[dt][o:o + n].view(shape)
                for dt, o, n, shape in self.layout]

    def fill(self, xs):
        for x, view in zip(xs, self.views(self.bufs)):
            view.copy_(x)

    def clone(self) -> list:
        """Views of a copy of the buffers: tensors the caller owns."""
        return self.views({dt: b.clone() for dt, b in self.bufs.items()})


class _Captured:
    """One key's graphs: static inputs, graph A (the step up to the
    solve), graph B (the rest, its outputs packed by dtype)."""

    def __init__(self, env, args, leaves, generator, extra, stream):
        dev = env.device
        self.device = dev
        self.static = [x.clone() for x in leaves]
        sargs = _rebuild(args, iter(self.static))
        mode = "thread_local"   # the CLI's evaluator thread runs alongside
        with torch.no_grad(), torch.cuda.device(dev):
            self.ga = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.ga, stream=stream,
                                  capture_error_mode=mode):
                self.pre, self.si = env.graph_pre(sargs)
            qf, lam0 = self.si.qfrc_smooth, self.si.lam0
            self.res = SolveResult(torch.empty_like(qf),
                                   torch.empty_like(qf),
                                   torch.empty_like(lam0))
            self.gb = torch.cuda.CUDAGraph()
            if generator is not None:
                self.gb.register_generator_state(generator)
            with torch.cuda.graph(self.gb, pool=self.ga.pool(),
                                  stream=stream, capture_error_mode=mode):
                self.out = env.graph_post(sargs, extra, self.pre, self.res,
                                          generator)
                outs = []
                _flatten(self.out, outs, [])
                self.packed = _Packed(outs, dev)
                self.packed.fill(outs)
        self.generator = generator   # held, so its id keys only it

    def replay(self, leaves, engine):
        with torch.cuda.device(self.device):
            for s, x in zip(self.static, leaves):
                s.copy_(x)
            self.ga.replay()
            res = engine.solve(self.si)
            for s, x in zip(self.res, res):
                s.copy_(x)
            self.gb.replay()
            own = self.packed.clone()
        return _rebuild(self.out, iter(own))


class StepGraphs:
    """An env's ``step_auto_reset`` behind its captured graphs. The env
    gives ``graph_pre(args) -> (pre, solve inputs)``, ``engine``
    and ``graph_post(args, extra, pre, solve result, generator) ->
    (state, out)``."""

    def __init__(self, env):
        self.env = env
        self._calls = {}      # key -> eager calls so far
        self._graphs = {}     # key -> _Captured
        self._stream = None

    def step(self, args, generator, extra, eager):
        """The step of tensor arguments ``args`` (a nest of tuples),
        ``generator`` and the other arguments ``extra`` (the shard),
        replayed where the graphs apply; ``eager()`` otherwise."""
        env = self.env
        leaves, sig = [], []
        _flatten(args, leaves, sig)
        if (env.device.type != "cuda" or env.engine.integrator == RK4
                or (torch.is_grad_enabled()
                    and any(x.requires_grad for x in leaves))):
            tracing.count("env.graph_eager", 1)
            return eager()
        key = (tuple(sig), id(generator),
               tuple(_shard_key(s) for s in extra))
        g = self._graphs.get(key)
        if g is None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(env.device)
            n = self._calls.get(key, 0)
            if n < WARMUP_CALLS or tracing.profiling():
                self._calls[key] = n + 1
                tracing.count("env.graph_eager", 1)
                return self._on_stream(eager)
            g = self._graphs[key] = _Captured(env, args, leaves, generator,
                                              extra, self._stream)
        tracing.count("env.graph_replays", 1)
        return g.replay(leaves, env.engine)

    def _on_stream(self, fn):
        """``fn()`` on the capture stream, ordered after and before the
        current stream's work (lazy set-up on that stream, cuBLAS's
        workspace among it, then happens before a capture)."""
        cur = torch.cuda.current_stream(self.env.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn()
        cur.wait_stream(self._stream)
        return out
