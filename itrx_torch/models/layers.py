"""Initializers of the reference, drawn from a torch.Generator (counterpart
of the parts of itrx/models/layers.py that SCAN needs)."""

from __future__ import annotations

import math

import torch
from torch import nn


def xavier_linear(in_features: int, out_features: int,
                  generator: torch.Generator | None = None) -> nn.Linear:
    """Linear with the reference's uniform xavier weight U(-r, r),
    r = sqrt(6) / sqrt(in + out), and a zero bias."""
    fc = nn.Linear(in_features, out_features)
    r = math.sqrt(6.0) / math.sqrt(in_features + out_features)
    with torch.no_grad():
        fc.weight.uniform_(-r, r, generator=generator)
        fc.bias.zero_()
    return fc


def torch_embedding(vocab_size: int, word_dim: int,
                    generator: torch.Generator | None = None) -> nn.Embedding:
    """Word embedding with the reference's U(-0.1, 0.1) init."""
    emb = nn.Embedding(vocab_size, word_dim)
    with torch.no_grad():
        emb.weight.uniform_(-0.1, 0.1, generator=generator)
    return emb
