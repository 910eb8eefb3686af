"""Spans and counters of the program, on the profiler's clock.

``span(name)`` times a block of host code: ``with span("env.step"):``.
Off (the default) it returns one shared no-op object after a check of
two flags, and calls no clock. It records while collection is on:

- while a ``torch.profiler`` profile is active (its own flag, read from
  ``torch.autograd.profiler``), so a profiled window holds the spans of
  the calls it covers with no change to the caller;
- inside ``collect()``, in the thread that opened it (the training
  CLI's evaluator thread records nothing of its own there).

A record (``Span``) holds its name, its start and end from
``time.time_ns()`` (the clock torch.profiler stamps its host and device
events with, so spans lie on a trace's timeline as they are), the id of
the span open around it in the same thread (``parent``), the id of the
outermost one (``root``: the spans of one env step or one PPO iteration
share it) and the thread. Records stay in memory until ``reset()``.

Only ``collect(annotate=True)`` also opens a
``torch.profiler.record_function`` range per span, so that a Chrome
trace shows the stages on its CPU and GPU rows: such a range becomes a
device-side annotation event, which a profile taken by someone else
(the benchmark's) would count among its device events. So a profile
the program did not ask to annotate gets the spans in memory only.

``setup(name)`` spans are recorded always (a handful per env build).
``count(name, value)`` adds a counter value where collection is on; a
tensor value is kept by reference and summed only when read
(``Snapshot.total``), so the recorder launches no kernel, copies nothing
and never synchronises, on or off. A kept tensor holds its storage on
the card, so a counter keeps at most ``PENDING`` values: the next one
folds them into a running sum on the host (their reductions and one
synchronisation), which only a collection longer than ``PENDING`` solve
calls ever pays (a profiled window of the benchmark holds 8 to 64).

Span names (parents indented):

    setup.model setup.tables setup.mocap setup.kernel setup.train_state
    ppo.iter
      ppo.rollout
        ppo.policy
        env.step                  (step_auto_reset of either env)
          env.physics             (Engine.step; RK4 repeats its children)
            engine.kinematics engine.collision engine.dynamics
            engine.constraints
              engine.solve
            engine.integrate
          env.obs env.reward env.done env.reset
        ppo.handoff
      ppo.gae
      ppo.update
        ppo.minibatch
        ppo.host_read
      ppo.host_read

Counters: ``solve.slots``, ``solve.active_slots``, ``solve.limit_rows``,
``solve.active_limit_rows`` (one value per fused-solve call).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
# its ``_is_profiler_enabled`` flag is set while a torch profiler runs
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    root: int
    thread: int


_collecting = 0          # open collect() blocks, in any thread
_spans: List[Span] = []
_counters: Dict[str, "_Counter"] = {}
PENDING = 256            # tensor values a counter keeps before folding
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Open:
    __slots__ = ("name", "id", "parent", "root", "start", "fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        self.root = up.root if up is not None else self.id
        stack.append(self)
        self.fn = None
        if getattr(_local, "annotating", 0):
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        _stack().pop()
        _spans.append(Span(self.id, self.name, self.start, end, self.parent,
                           self.root, threading.get_ident()))
        return False


def _here() -> bool:
    """Whether a collect() block is open in this thread."""
    return bool(getattr(_local, "collecting", 0))


def on() -> bool:
    """Whether spans and counters are being recorded in this thread."""
    return bool(_profiler._is_profiler_enabled or (_collecting and _here()))


def span(name: str):
    """A context manager timing its block as ``name`` where collection
    is on in this thread; the shared no-op ``OFF`` otherwise."""
    if not (_collecting or _profiler._is_profiler_enabled):
        return OFF
    return _Open(name) if on() else OFF


def setup(name: str):
    """A span recorded whether collection is on or not (set-up work)."""
    return _Open(name)


def spanned(name: str):
    """Decorator: each call of the function is a span ``name`` (a
    ``setup.`` name is recorded always)."""
    always = name.startswith("setup.")

    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            with (_Open(name) if always else span(name)):
                return fn(*args, **kw)
        return timed
    return wrap


def _sum(values) -> float:
    return sum(float(v.sum()) if isinstance(v, torch.Tensor) else v
               for v in values)


class _Counter:
    __slots__ = ("calls", "folded", "pending")

    def __init__(self):
        self.calls, self.folded, self.pending = 0, 0.0, []


def count(name: str, value):
    """Add ``value`` (a number, or a tensor summed when read) to counter
    ``name`` where collection is on."""
    if on():
        c = _counters.get(name)
        if c is None:
            c = _counters[name] = _Counter()
        if len(c.pending) == PENDING:
            c.folded += _sum(c.pending)
            c.pending = []
        c.calls += 1
        c.pending.append(value)


@contextlib.contextmanager
def collect(annotate: bool = False):
    """Record spans and counters inside the block; with ``annotate``,
    also open a ``record_function`` range per span for a profile's
    Chrome trace."""
    global _collecting
    _collecting += 1
    _local.collecting = getattr(_local, "collecting", 0) + 1
    _local.annotating = getattr(_local, "annotating", 0) + int(annotate)
    try:
        yield
    finally:
        _collecting -= 1
        _local.collecting -= 1
        _local.annotating -= int(annotate)


class Snapshot(NamedTuple):
    spans: List[Span]             # in the order they ended
    # by name: (calls, the folded sum, the values not yet folded)
    counters: Dict[str, Tuple[int, float, list]]

    def calls(self, name: str) -> int:
        return self.counters[name][0] if name in self.counters else 0

    def total(self, name: str) -> float:
        """The sum of counter ``name`` (tensors reduced here)."""
        if name not in self.counters:
            return 0.0
        _, folded, pending = self.counters[name]
        return folded + _sum(pending)


def snapshot() -> Snapshot:
    """The records so far."""
    return Snapshot(list(_spans), {
        k: (c.calls, c.folded, list(c.pending))
        for k, c in _counters.items()})


def reset():
    """Drop the spans and counters recorded so far."""
    _spans.clear()
    _counters.clear()


def seconds_by_name(spans, thread: Optional[int] = None) -> Dict[str, float]:
    """Host seconds of ``spans`` summed by name (of one ``thread``'s
    spans where given)."""
    out: Dict[str, float] = {}
    for s in spans:
        if thread is None or s.thread == thread:
            out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    return out
