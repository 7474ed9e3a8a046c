"""Shared by the port's entry points: where they run."""

from __future__ import annotations

import sys

import torch

NO_GPU = ("{}: torch.cuda.is_available() is False; the port runs on an NVIDIA GPU "
          "and has no CPU fallback (pass device=\"cpu\" to run on the CPU)")


def default_device(device, prog: str) -> torch.device:
    """`device` as given, or cuda:0 when it is None.  The entry points run on
    the card unless the caller asks for the CPU (`device="cpu"`); with no
    GPU, None raises rather than falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(NO_GPU.format(prog))
    return torch.device("cuda", 0)


def require_cuda(prog: str) -> torch.device:
    """cuda:0, or exit with an error when there is no GPU: the command-line
    entry points have no CPU fallback."""
    if not torch.cuda.is_available():
        print(NO_GPU.format(prog), file=sys.stderr)
        sys.exit(1)
    return torch.device("cuda", 0)
