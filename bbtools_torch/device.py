"""The explicit compute device of the port.

A tool runs where `device=` says, `cuda` by default. There is no silent
move to the CPU: asking for CUDA on a machine without it raises.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | None = None) -> torch.device:
    """`cuda`, `cuda:N` or `cpu` -> torch.device; raises when CUDA is
    asked for and absent."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={dev} requested but torch.cuda.is_available() is "
            "False; pass device=cpu to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={dev}: expected cuda, cuda:N or cpu")
    return dev
