"""On the card: the control (the reference in float32 with TF32
matmuls, in the program's place) fails a compared number of each cell,
and the program passes them, at a size a test run holds."""
import pytest

from bmk import spec

BENCH_JSON = spec.benchmark()
CELLS = [w["name"] for w in BENCH_JSON["workloads"]]
SMALL = dict(n_envs=512, check_from=32, horizon=16, minibatch_size=512,
             epochs=2, warmup_iters=1)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = spec.workload(BENCH_JSON, cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"the cell needs {chips} CUDA cards")
    import readings

    (line,) = readings.main(["--workload", cell, "--seeds", "4400000001",
                             "--control"], sizes=SMALL)
    limits = spec.limits(cell)
    assert all(v <= limits[k] for k, v in line["program"].items())
    assert any(v > limits[k] for k, v in line["control"].items())
