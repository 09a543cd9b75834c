"""Where the port's entry points run.

On the card unless the caller asks for the CPU: without a GPU and without an
explicit device, an entry point raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (default "cuda") as a torch.device; raises if it names CUDA
    and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the GPU unless the "
            "caller passes device='cpu'")
    return dev
