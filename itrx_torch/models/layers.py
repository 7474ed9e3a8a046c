"""Initializers of the reference, drawn from a torch.Generator, and the
dropout of the SGRAF modules with its own random stream (counterparts of
the parts of itrx/models/layers.py and flax's Dropout that SCAN and SGRAF
need)."""

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


class DropoutRNG:
    """The random stream of a model's dropout masks: one torch.Generator per
    device, all seeded from one seed.  `manual_seed` reseeds every one of
    them (the train step reseeds from the run's seed and the update count,
    so a resumed run draws the masks an uninterrupted one draws)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._gens: dict = {}

    def manual_seed(self, seed: int) -> None:
        self.seed = int(seed)
        for g in self._gens.values():
            g.manual_seed(self.seed)

    def generator(self, device) -> torch.Generator:
        device = torch.device(device)
        if device not in self._gens:
            self._gens[device] = torch.Generator(device=device).manual_seed(self.seed)
        return self._gens[device]


class SeededDropout(nn.Module):
    """Inverted dropout (torch.nn.Dropout's arithmetic: kept values scaled by
    1 / (1 - p)) whose masks come from `rng`, a DropoutRNG shared by the
    model.  Identity in eval mode and at p == 0.  It holds no state, so a
    Sequential keeps the reference's indices and state-dict keys."""

    def __init__(self, p: float, rng: DropoutRNG | None = None):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = float(p)
        self.rng = rng if rng is not None else DropoutRNG()

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        u = torch.rand(x.shape, generator=self.rng.generator(x.device), device=x.device)
        return x * (u >= self.p).to(x.dtype) / (1.0 - self.p)

    def extra_repr(self) -> str:
        return f"p={self.p}"
