"""Milliseconds of collectives (NCCL kernels) in one traced iteration
on rank 0 of a data-parallel cell (see ``bmk.layer``)."""
from bmk import layer


def read(ctx):
    return layer.collective_ms_per_iter(ctx)
