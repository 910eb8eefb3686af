"""The SAC cell's counts and sizes: ``counts/sac.py`` against what
autograd really computes in the port's collect step and update (torch's
own ``FlopCounterMode`` over the port's calls, at small widths), the
driver's replay-buffer rows at the cell's and the tests' sizes, the
plain reference's imports, and the program's SAC spans read by a traced
CPU run."""
import json
import subprocess
import sys
from typing import NamedTuple

import pytest
import torch

from bmk import run as bmk_run
from bmk import spec
from conftest import BENCH, TINY
from counts import sac as counts

CELL = "unitree_g1_sac.sac_walk"
OBS, ACT, ARCH, N_ENVS, BATCH = 7, 3, (16, 8), 4, 5


class Out(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


class Table:
    """An env of fixed obs, rewards and dones, whose step does no matrix
    product: the counter sees the networks alone."""
    obs_size, action_size = OBS, ACT
    device = torch.device("cpu")

    def reset(self, n_envs, generator=None):
        return 0, torch.ones(n_envs, OBS)

    def step_auto_reset(self, t, action, generator=None):
        n = action.shape[0]
        return t + 1, Out(torch.full((n, OBS), 0.5), torch.ones(n),
                          torch.zeros(n, dtype=torch.bool))


def _counted(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", [ARCH, (32,)])
def test_counts_are_what_autograd_computes(arch):
    from deepmimic_mujoco_tpu_torch.rl.sac import SAC, SACConfig

    sac = SAC(Table(), SACConfig(n_envs=N_ENVS, buffer_size=64,
                                 batch_size=BATCH, steps_per_iter=1,
                                 updates_per_iter=1, net_arch=arch))
    s = sac.init(seed=0)
    collect = _counted(lambda: sac.collect(s))
    assert collect == N_ENVS * counts.actor_flops(OBS, ACT, arch)
    update = _counted(lambda: sac.update_step(s, N_ENVS, 1.0))
    assert update == BATCH * counts.update_sample_flops(OBS, ACT, arch)
    # what one forward of the twin critics costs, by the same counter
    with torch.no_grad():
        obs, act = torch.zeros(BATCH, OBS), torch.zeros(BATCH, ACT)
        assert _counted(lambda: s.critic(obs, act)) == \
            2 * BATCH * counts.critic_flops(OBS, ACT, arch)


def test_cell_sizes_the_update_and_the_buffer():
    b = spec.benchmark()
    cfg = spec.config(b, "unitree_g1_sac")
    tr = spec.traffic(spec.workload(b, CELL)["traffic"])
    drv = spec.module("drivers", tr["driver"])
    assert drv.buffer_rows(cfg, tr["sac"], tr["sac"]) == 5_000_000
    row_bytes = 4 * (2 * cfg["obs_size"] + cfg["action_size"] + 2)
    assert row_bytes == 780
    # the tests' ring holds a few of their iterations, more than one
    tiny = drv.buffer_rows(cfg, tr["sac"], dict(tr["sac"], **{
        k: v for k, v in TINY.items() if k in tr["sac"]}))
    per_iter = TINY["n_envs"] * TINY["horizon"]
    assert per_iter < tiny <= 4 * per_iter and tiny * row_bytes <= 100e6
    # the sizing the configuration was chosen by: ~20 MFLOP a sample,
    # ~2 TFLOP an iteration's 48 updates of 2048
    per = counts.update_sample_flops(cfg["obs_size"], cfg["action_size"],
                                     cfg["net_arch"], cfg["critics"])
    assert 19e6 < per < 21e6
    it = per * tr["sac"]["updates_per_iter"] * tr["sac"]["minibatch_size"]
    assert 1.9e12 < it < 2.1e12


def test_reference_sac_imports_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from reference import sac\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'deepmimic_mujoco_tpu', "
            "'deepmimic_mujoco_tpu_torch'})\n"
            "print(bad)") % BENCH
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/")
    assert out.stdout.strip() == "[]"


def test_traced_run_reads_the_sac_spans(capsys):
    from deepmimic_mujoco_tpu_torch.utils import tracing

    tracing.reset()
    out = bmk_run.main(["--workload", CELL, "--seed", "4000000017",
                        "--seconds", "0.5", "--trace", "1"],
                       device="cpu", sizes=TINY)
    printed = capsys.readouterr().out.strip().splitlines()
    info = json.loads(printed[-2][len("info "):])
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for name in ("sac_update_s.train", "sac_collect_s.train",
                 "sac_update_step_host_ms.train",
                 "train_env_steps_per_s.train"):
        assert got[name] > 0, name
    # the CPU profile holds no device kernel: no share of the peak
    assert "sac_mfu.train" not in got
    tr = spec.traffic("sac_walk")
    spans = info["sac_spans"]
    assert spans["updates"] == tr["sac"]["updates_per_iter"]
    # filled in set-up: the profiled iteration's updates draw from the
    # whole ring
    assert info["fill_collects"] > 0
    assert spans["buffer_rows"] == info["buffer_rows"]
    assert {"sac.iter", "sac.collect", "sac.policy", "sac.buffer_write",
            "sac.update", "sac.update_step"} <= set(spans["seconds"])
    assert info["window_env_steps"] == info["window_iters"] * TINY[
        "n_envs"] * TINY["horizon"]
    tracing.reset()
