"""Wall-clock timers with device synchronisation (PyTorch port of
stnls_tpu/utils/timer.py, the reference's ExpTimer/ExpTimerList).

`sync` waits for the card's queued work (torch.cuda.synchronize) once a
CUDA context exists, so a named region times the device work launched
inside it; with no context (CPU tensors only) it does nothing. For a
kernel's own time prefer CUDA events (attn_step.cuda_ms).
"""

import time

import torch


def sync(device=None):
    if torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


class ExpTimer:

    def __init__(self, use_timer=True):
        self.use_timer = use_timer
        self.times = {}
        self._starts = {}

    def __str__(self):
        return str(self.times)

    def names(self):
        return list(self.times.keys())

    def start(self, name):
        if not self.use_timer:
            return
        self._starts[name] = time.perf_counter()

    def stop(self, name):
        if not self.use_timer:
            return
        self.times[name] = time.perf_counter() - self._starts.pop(name)

    def sync_start(self, name):
        if not self.use_timer:
            return
        sync()
        self.start(name)

    def sync_stop(self, name):
        if not self.use_timer:
            return
        sync()
        self.stop(name)

    def __getitem__(self, name):
        return self.times[name]

    def items(self):
        return self.times.items()


class ExpTimerList:
    """Accumulates per-name timing lists across calls."""

    def __init__(self, use_timer=True):
        self.use_timer = use_timer
        self.times = {}

    def update_times(self, timer):
        if not self.use_timer:
            return
        for name, val in timer.items():
            self.times.setdefault(name, []).append(val)

    def names(self):
        return list(self.times.keys())

    def __getitem__(self, name):
        return self.times[name]

    def __str__(self):
        return str({k: sum(v) / max(len(v), 1)
                    for k, v in self.times.items()})

    def reset(self):
        self.times = {}
