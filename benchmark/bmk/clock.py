"""Per-step times from CUDA events recorded on the stream after each
step (no host sync; read once the window has closed), or the host clock
on the CPU."""
import time


class StepClock:
    def __init__(self, device):
        import torch

        self.cuda = str(device).startswith("cuda")
        self._torch = torch
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = self._torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        """Gaps between consecutive marks, in ms (call after a sync)."""
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m[:-1], m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m[:-1], m[1:])]
