"""Faults planted in the port's timed path, for the readings of the
limits and for the tests that see ``correct`` come out false. Each is a
file ``faults/<name>.py`` whose ``plant(patch)`` plants it; a driver's
``FAULTS`` names those whose planting must make its cells not correct."""
import contextlib

from bmk import spec


@contextlib.contextmanager
def fault(name):
    """The port with fault ``name`` planted, for the block (none for
    ``None``)."""
    saved = []

    def patch(obj, attr, make):
        orig = getattr(obj, attr)
        saved.append((obj, attr, orig))
        setattr(obj, attr, make(orig))

    try:
        if name:
            spec.module("faults", name).plant(patch)
        yield
    finally:
        for obj, attr, orig in reversed(saved):
            setattr(obj, attr, orig)
