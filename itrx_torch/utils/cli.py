"""Shared by the port's entry points: where they run."""

from __future__ import annotations

import sys

import torch

NO_GPU = ("{}: torch.cuda.is_available() is False; the port runs on an NVIDIA GPU "
          "and has no CPU fallback (pass device=\"cpu\" to run on the CPU)")


def default_device(device, prog: str) -> torch.device:
    """`device` as given, or cuda:0 when it is None.  The entry points run on
    the card unless the caller asks for the CPU (`device="cpu"`); with no
    GPU, None raises rather than falling back to the CPU.  On the card it
    turns TF32 off, so that fp32 configurations compute in fp32 as on the
    CPU and in the JAX package (cuDNN rounds fp32 convolutions to TF32
    unless told not to), and makes cuBLAS's bf16 products accumulate in
    fp32 throughout, as `itrx`'s bf16 dots do (preferred_element_type
    fp32)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(NO_GPU.format(prog))
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


def require_cuda(prog: str) -> torch.device:
    """cuda:0, or exit with an error when there is no GPU: the command-line
    entry points have no CPU fallback."""
    if not torch.cuda.is_available():
        print(NO_GPU.format(prog), file=sys.stderr)
        sys.exit(1)
    return torch.device("cuda", 0)
