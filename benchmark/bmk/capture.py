"""Copies of what the timed path produced, kept for the check."""
import numpy as np


def clone(x):
    """A copy of a tensor, or of a tuple of them (a NamedTuple keeps its
    type); None stays None."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*[clone(v) for v in x]) if hasattr(x, "_fields") \
            else tuple(clone(v) for v in x)
    return x.detach().clone()


def sample_steps(seed: int, first: int, count: int):
    """``count`` distinct step indices below ``first``, drawn from the
    seed."""
    rng = np.random.default_rng(seed)
    return set(int(i) for i in rng.choice(first, size=min(count, first),
                                          replace=False))
