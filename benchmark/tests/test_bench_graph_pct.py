"""The readers of ``env_step_graph_pct.*``: the program's
``env.graph_replays`` counter over its ``env.step`` spans, None where the
program counts neither replays nor eager steps (as before the env step
was replayed as CUDA graphs)."""
import types

import pytest

from bmk import spec

READERS = ("env_step_graph_pct.rollout", "env_step_graph_pct.train")


def _record(steps, counter):
    """``steps`` env.step spans, each counting ``counter`` (or nothing)."""
    from deepmimic_mujoco_tpu_torch.utils import tracing

    tracing.reset()
    with tracing.collect():
        for _ in range(steps):
            with tracing.span("env.step"):
                if counter:
                    tracing.count(counter, 1)


@pytest.mark.parametrize("name", READERS)
def test_graph_pct_reads_replays_over_steps(name):
    from deepmimic_mujoco_tpu_torch.utils import tracing

    read = spec.module("metrics", name).read
    ctx = types.SimpleNamespace(info={}, profile=None)
    try:
        _record(4, None)
        assert read(ctx) is None
        _record(4, "env.graph_replays")
        assert read(ctx) == 100.0
        _record(4, "env.graph_eager")
        assert read(ctx) == 0.0
        _record(0, None)
        assert read(ctx) is None
    finally:
        tracing.reset()
