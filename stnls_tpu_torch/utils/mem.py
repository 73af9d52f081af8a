"""Device-memory probes (PyTorch port of stnls_tpu/utils/mem.py, the
reference's gpu_mem print_gpu_stats/GpuRecord).

On the card they read torch.cuda.memory_allocated and
max_memory_allocated of the current device, and reset_peak_gpu_stats
resets the peak (torch.cuda.reset_peak_memory_stats). With no CUDA
context (CPU tensors only) every probe reads 0, as the JAX package's do
off the TPU.
"""

import torch


def _on_card():
    return torch.cuda.is_initialized()


def bytes_in_use():
    return torch.cuda.memory_allocated() if _on_card() else 0


def peak_bytes():
    return torch.cuda.max_memory_allocated() if _on_card() else 0


def print_gpu_stats(verbose=True, name="-"):
    mem = bytes_in_use() / (1024. ** 3)
    if verbose:
        print(f"[{name}] device memory: {mem:2.3f} GB")
    return mem


def print_peak_gpu_stats(verbose=True, name="-"):
    mem = peak_bytes() / (1024. ** 3)
    if verbose:
        print(f"[{name}] peak device memory: {mem:2.3f} GB")
    return mem


def reset_peak_gpu_stats():
    """Reset the card's peak to the memory in use now; returns it."""
    if _on_card():
        torch.cuda.reset_peak_memory_stats()
    return peak_bytes()


class GpuRecord:
    """Named (mem, peak) snapshots in GB (reference GpuRecord)."""

    def __init__(self, use_record=True):
        self.use_record = use_record
        self.mems = {}

    def snap(self, name):
        if not self.use_record:
            return
        self.mems[name] = (bytes_in_use() / (1024. ** 3),
                           peak_bytes() / (1024. ** 3))

    def items(self):
        return self.mems.items()

    def names(self):
        return list(self.mems.keys())

    def __getitem__(self, name):
        return self.mems[name]

    def __str__(self):
        return str(self.mems)
