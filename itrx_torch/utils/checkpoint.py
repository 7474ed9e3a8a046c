"""Checkpoints in the original reference's `.pth.tar` layout (counterpart of
itrx/utils/checkpoint.py).

A checkpoint is the dict the reference's train.py saves with torch.save:

    {"epoch", "model": [img_enc.state_dict(), txt_enc.state_dict()],
     "best_rsum", "best_r1", "opt": optimizer.state_dict(), "Eiters",
     "_config"}

so `itrx.utils.ref_convert.convert_reference_checkpoint` reads a port
checkpoint unchanged.  Files are `epo{epoch}_checkpoint.pth.tar` (end of
epoch) and `model_best.pth.tar`.  The key is always `best_r1` (the
reference's epoch-end files wrote `best_rl`, its bug #2, fixed as in the
JAX package).
"""

from __future__ import annotations

import os

import torch

ENCODERS = ("img_enc", "txt_enc")


def state_list(model) -> list:
    """The reference's state-dict list [img_enc, txt_enc], on the CPU."""
    return [
        {k: v.detach().cpu() for k, v in getattr(model, name).state_dict().items()}
        for name in ENCODERS
    ]


def load_state_list(model, states: list) -> None:
    """Load [img_enc, txt_enc] state dicts into `model` (strict)."""
    if len(states) != len(ENCODERS):
        raise ValueError(f"expected {len(ENCODERS)} state dicts, got {len(states)}")
    for name, sd in zip(ENCODERS, states):
        getattr(model, name).load_state_dict(sd, strict=True)


def save_checkpoint(state, config: dict, epoch: int, best_rsum: float,
                    best_r1: float, filename: str) -> str:
    """Write `state` (an itrx_torch.train.state.TrainState) atomically."""
    ckpt = {
        "epoch": int(epoch),
        "model": state_list(state.model),
        "best_rsum": float(best_rsum),
        "best_r1": float(best_r1),
        "opt": state.optimizer.state_dict(),
        "Eiters": int(state.step),
        "_config": dict(config),
    }
    tmp = filename + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, filename)
    return filename


def load_checkpoint(filename: str) -> dict:
    """Read a checkpoint onto the CPU (tensors, numbers and the config
    only: no pickled code is run)."""
    return torch.load(filename, map_location="cpu", weights_only=True)


def save_train_checkpoint(state, config: dict, epoch: int, best_rsum: float,
                          best_r1: float, is_best: bool, prefix: str = "",
                          is_epo_end: bool = False) -> list:
    """Mirror of the reference's save_checkpoint: the epoch-end file and the
    best file.  Returns the paths written."""
    written = []
    if is_epo_end:
        written.append(save_checkpoint(
            state, config, epoch, best_rsum, best_r1,
            os.path.join(prefix, f"epo{epoch}_checkpoint.pth.tar")))
    if is_best:
        written.append(save_checkpoint(
            state, config, epoch, best_rsum, best_r1,
            os.path.join(prefix, "model_best.pth.tar")))
    return written
