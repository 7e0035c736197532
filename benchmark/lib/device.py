"""Device calls that also run on the CPU (the harness's own tests)."""

import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def release(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
