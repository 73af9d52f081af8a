"""Benchmark context manager combining timers and memory probes
(PyTorch port of stnls_tpu/utils/bench.py, the reference's RecordIt)."""

from contextlib import contextmanager

from stnls_tpu_torch.utils.timer import ExpTimer, ExpTimerList
from stnls_tpu_torch.utils.mem import GpuRecord


class RecordIt:

    def __init__(self, use_record=True):
        self.use_record = use_record
        self.timers = ExpTimerList(use_record)
        self.mems = GpuRecord(use_record)

    @contextmanager
    def __call__(self, name):
        timer = ExpTimer(self.use_record)
        timer.sync_start(name)
        try:
            yield self
        finally:
            timer.sync_stop(name)
            self.timers.update_times(timer)
            self.mems.snap(name)

    def summary(self):
        return {"times": dict(self.timers.times),
                "mems": dict(self.mems.mems)}

    def __str__(self):
        return f"times={self.timers} mems={self.mems}"
