"""Shared by the port's command-line entry points."""

from __future__ import annotations

import sys

import torch


def require_cuda(prog: str) -> torch.device:
    """cuda:0, or exit with an error when there is no GPU: the entry points
    have no CPU fallback."""
    if not torch.cuda.is_available():
        print(f"{prog}: torch.cuda.is_available() is False; the port runs on an "
              "NVIDIA GPU and has no CPU fallback", file=sys.stderr)
        sys.exit(1)
    return torch.device("cuda", 0)
