"""Initializers of the reference, drawn from a torch.Generator, the
BatchNorm of `itrx`'s TorchBatchNormCore over the last axis, and the dropout
of the SGRAF, VSRN and CAMERA modules with its own random stream
(counterparts of the parts of itrx/models/layers.py and flax's Dropout that
SCAN, SGRAF, VSRN and CAMERA need)."""

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


def torch_linear(in_features: int, out_features: int, bias: bool = True,
                 generator: torch.Generator | None = None) -> nn.Linear:
    """Linear with torch's default init drawn from `generator`: weight and
    bias U(-k, k), k = 1 / sqrt(in) (`itrx`'s TorchLinear)."""
    fc = nn.Linear(in_features, out_features, bias=bias)
    k = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        fc.weight.uniform_(-k, k, generator=generator)
        if bias:
            fc.bias.uniform_(-k, k, generator=generator)
    return fc


def torch_conv1d(in_channels: int, out_channels: int, kernel_size: int, dilation: int = 1,
                 padding: int = 0, generator: torch.Generator | None = None) -> nn.Conv1d:
    """Conv1d with torch's default init drawn from `generator`: weight and
    bias U(-k, k), k = 1 / sqrt(in x kernel_size)."""
    conv = nn.Conv1d(in_channels, out_channels, kernel_size, dilation=dilation,
                     padding=padding)
    k = 1.0 / math.sqrt(in_channels * kernel_size)
    with torch.no_grad():
        conv.weight.uniform_(-k, k, generator=generator)
        conv.bias.uniform_(-k, k, generator=generator)
    return conv


def xavier_normal_linear(in_features: int, out_features: int,
                         generator: torch.Generator | None = None) -> nn.Linear:
    """Linear with a xavier-normal weight, N(0, 2 / (in + out)), and a zero
    bias (flax's Dense with `xavier_normal`, as `itrx`'s VSRN decoder
    draws it)."""
    fc = nn.Linear(in_features, out_features)
    std = math.sqrt(2.0 / (in_features + out_features))
    with torch.no_grad():
        fc.weight.normal_(0.0, std, generator=generator)
        fc.bias.zero_()
    return fc


class TorchBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of (..., C) as `itrx`'s
    TorchBatchNormCore computes it: in train mode the statistics pool every
    other axis (B, or B x N for region tensors, as the reference's
    BatchNorm1d on (B, C, N)), in fp32 whatever the input dtype, and the
    running variance takes the unbiased estimate (momentum 0.1, eps 1e-5);
    in eval mode the running statistics.  The fp32 statistics are cast to the
    input's dtype before they normalize it, so a bf16 input (bf16 encode, its
    weight and bias cast to bf16, the running statistics left fp32) runs in
    bf16 where torch's batch_norm refuses the mix.  The state-dict keys are
    BatchNorm1d's."""

    def forward(self, x):
        dt = x.dtype
        if self.training:
            xf = x.float().reshape(-1, self.num_features)
            var, mean = torch.var_mean(xf, dim=0, correction=0)
            n = xf.shape[0]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
                self.running_var.mul_(1.0 - m).add_(m * var.detach() * (n / max(n - 1, 1)))
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        inv = torch.rsqrt(var + self.eps).to(dt)
        return (x - mean.to(dt)) * (inv * self.weight.to(dt)) + self.bias.to(dt)


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
        return x * self._keep(x.shape, x.device).to(x.dtype) / (1.0 - self.p)

    def _keep(self, shape, device):
        u = torch.rand(shape, generator=self.rng.generator(device), device=device)
        return u >= self.p

    def mask(self, shape, device, dtype=torch.float32):
        """The next mask of the stream, scaled as forward scales: 0 at dropped
        entries, 1 / (1 - p) at kept ones; all ones in eval mode and at p 0."""
        if not self.training or self.p == 0.0:
            return torch.ones(shape, dtype=dtype, device=device)
        return self._keep(shape, device).to(dtype) / (1.0 - self.p)

    def extra_repr(self) -> str:
        return f"p={self.p}"
