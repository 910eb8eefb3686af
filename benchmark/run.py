"""The benchmark of deepmimic_mujoco_tpu_torch on the H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout,
and prints its result as the last line of standard output. It needs as
many CUDA cards as the cell asks for."""
import os
import sys
import time

T0 = time.time()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    from bmk.run import main

    main(t0=T0)
