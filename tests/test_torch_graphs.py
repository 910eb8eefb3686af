"""The env step split at the fused solve, on the CPU.

On the card ``step_auto_reset`` replays the Euler step as two CUDA
graphs around the solve's call (``envs/graphs.py``; its card tests are
in ``test_torch_cuda.py``). Here: the CPU step runs eager and counts
so; the engine's split step (``step_pre``, ``solve``, ``step_post``) is
``Engine.step`` bit for bit; and the two halves the graphs capture,
run in turn around the solve, are the eager ``step_auto_reset`` bit
for bit, resets and generator draws included; the replay's packed
outputs come back as tensors the caller owns and can save.
"""
import io

import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu_torch.envs import DPEnv
from deepmimic_mujoco_tpu_torch.utils import tracing

B = 6


@pytest.fixture(scope="module")
def h3d():
    return DPEnv(motion="walk", robot="humanoid3d", device="cpu")


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [y for v in x for y in _leaves(v)]
    return []


def _same(a, b):
    """Bit for bit (floats compared as their bits, so NaN equals NaN)."""
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(bits(a), bits(b)))


def _actions(env, steps, scale):
    r = np.random.RandomState(4)
    return [torch.tensor(r.uniform(-scale, scale, (B, env.action_size)),
                         dtype=torch.float32) for _ in range(steps)]


def test_cpu_step_runs_eager_and_counts_it(h3d):
    g = torch.Generator().manual_seed(0)
    states, _ = h3d.reset(B, generator=g)
    tracing.reset()
    with torch.no_grad(), tracing.collect():
        for a in _actions(h3d, 3, 0.3):
            states, _ = h3d.step_auto_reset(states, a, g)
    snap = tracing.snapshot()
    tracing.reset()
    assert snap.calls("env.graph_eager") == 3
    assert snap.calls("env.graph_replays") == 0
    assert sum(s.name == "env.step" for s in snap.spans) == 3


def test_split_engine_step_matches_engine_step(h3d):
    """Two Euler steps (the second warm-started from the first) of
    ``Engine.step`` and of ``step_pre`` -> ``solve`` -> ``step_post``,
    from the walk clip at six frames under one action."""
    eng = h3d.engine
    state = h3d._fresh_state(torch.tensor([0, 12, 24, 36, 48, 60]))
    ctrl = h3d._mujoco_action(_actions(h3d, 1, 0.5)[0])
    with torch.no_grad():
        q, v, lam = state.qpos, state.qvel, state.lam
        qs, vs, lams = q, v, lam
        for _ in range(2):
            q, v, d = eng.step(q, v, ctrl, lam0=lam)
            pre, si = eng.step_pre(qs, vs, ctrl, lam0=lams)
            qs, vs, ds = eng.step_post(qs, vs, pre, eng.solve(si))
            lam, lams = d.lam, ds.lam
            for a, b in zip(_leaves((q, v, d)), _leaves((qs, vs, ds))):
                assert _same(a, b)
    assert float(lam[:, :eng.n_warm_rows - eng.k_slots].abs().sum()) > 0


def _halves(env, args, generator, extra):
    """The step as ``envs/graphs.py`` runs it, here op by op."""
    pre, si = env.graph_pre(args)
    return env.graph_post(args, extra, pre, env.engine.solve(si), generator)


@pytest.mark.parametrize("kind", ["dp", "combined"])
def test_graph_halves_match_the_eager_step(kind):
    """``graph_pre``, the solve and ``graph_post`` in turn equal
    ``step_auto_reset_eager`` bit for bit over 8 steps (episodes of 4
    steps, so every env resets) and leave the generator where the eager
    step leaves it; the combined env with its handoff buffer."""
    from deepmimic_mujoco_tpu_torch.envs import (
        DPCombinedEnv, DPCombinedEnvConfig, DPEnvConfig,
    )

    if kind == "dp":
        env = DPEnv(motion="walk", robot="humanoid3d",
                    cfg=DPEnvConfig(MAX_EP_LENGTH=4), device="cpu")
    else:
        env = DPCombinedEnv(cfg=DPCombinedEnvConfig(
            MAX_EP_LENGTH=4, HANDOFF_BUFFER_FRAC=0.5, FACEDOWN_RSI_FRAC=0.2),
            device="cpu")
    acts = _actions(env, 8, 0.5)
    runs = []
    for split in (False, True):
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            state, _ = env.reset(B, generator=g)
            buf = env.make_handoff_buffer(8) if kind == "combined" else None
            outs = []
            for a in acts:
                args = (state, a) if buf is None else (state, a, buf, None)
                if split:
                    state, out = _halves(env, args, g, (None,))
                else:
                    state, out = env.step_auto_reset_eager(*args[:2], g,
                                                           *args[2:])
                if buf is not None:
                    buf = env.update_handoff_buffer(
                        buf, out.done, state.qpos, state.qvel,
                        state.player_action, out.motion_id)
                outs.append((state, out, buf))
        runs.append((outs, torch.rand(4, generator=g)))
    (want, want_next), (got, got_next) = runs
    assert sum(int(o[1].done.sum()) for o in want) > 0
    for w, s in zip(want, got):
        for a, b in zip(_leaves(w), _leaves(s), strict=True):
            assert _same(a, b)
    assert _same(want_next, got_next)


def test_packed_outputs_are_the_callers_and_save(h3d):
    """A replay returns its outputs as views of per-dtype copies of its
    packed buffers (``envs/graphs.py:_Packed``): equal to the step's
    outputs bit for bit, untouched by the next replay's writes, and
    ``torch.save`` takes them (it refuses views of one storage as two
    dtypes)."""
    from deepmimic_mujoco_tpu_torch.envs.graphs import _Packed, _rebuild

    g = torch.Generator().manual_seed(2)
    states, _ = h3d.reset(B, generator=g)
    with torch.no_grad():
        step = h3d.step_auto_reset_eager(states, _actions(h3d, 1, 0.3)[0],
                                         g)
    leaves = _leaves(step)
    packed = _Packed(leaves, "cpu")
    packed.fill(leaves)
    state, out = _rebuild(step, iter(packed.clone()))
    for buf in packed.bufs.values():
        buf.fill_(0)
    for a, b in zip(leaves, _leaves((state, out)), strict=True):
        assert _same(a, b)
    saved = dict(state._asdict(), obs=out.obs, done=out.done)
    blob = io.BytesIO()
    torch.save(saved, blob)
    blob.seek(0)
    back = torch.load(blob)
    for k, v in saved.items():
        assert _same(v, back[k]), k
