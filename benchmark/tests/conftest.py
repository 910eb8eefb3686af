"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``
(the card's tests: ``-m gpu`` on the card). The benchmark's folder and
the checkout's root go on the path, as ``benchmark/run.py`` puts them."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# the CPU runs' sizes: a handful of envs, a few steps, tiny minibatches
TINY = dict(n_envs=8, warmup_steps=2, check_steps=2, check_from=4,
            trace_steps=2, horizon=4, minibatch_size=8, epochs=2,
            warmup_iters=1)
