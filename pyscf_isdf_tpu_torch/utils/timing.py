"""Stage timer: wall-clock seconds per named stage, device synchronised."""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch


def null_timer(name: str):
    """The timer used when none is given: times nothing."""
    return nullcontext()


class StageTimer:
    """``with timer("name"):`` adds the stage's seconds to
    ``timer.seconds["name"]`` (a list, one entry per entry into the stage).
    On a CUDA device the stream is synchronised before and after the
    stage, so the time covers the device work the stage enqueued."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.seconds: dict[str, list[float]] = {}

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
