"""Image encoders over precomputed region features (counterparts of
itrx/models/img_encoders.py: EncoderImagePrecomp, the `basic` variant, and
VSRN's EncoderImagePrecompAttn with its RsGCN blocks)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import l2norm
from ..ops.rnn import MaskedGRU
from .layers import TorchBatchNorm, xavier_linear


class EncoderImagePrecomp(nn.Module):
    """Linear img_dim -> embed_size, then l2norm over the feature axis.
    Works on (B, D) or (B, R, D) features."""

    def __init__(self, img_dim: int, embed_size: int, no_imgnorm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.no_imgnorm = no_imgnorm
        self.fc = xavier_linear(img_dim, embed_size, generator)

    def forward(self, images):
        features = self.fc(images)
        if not self.no_imgnorm:
            features = l2norm(features, dim=-1)
        return features


def _conv1x1(in_ch: int, out_ch: int, generator: torch.Generator | None) -> nn.Conv1d:
    """A 1x1 Conv1d (the reference's layout, weight (out, in, 1)) with torch's
    default init U(-k, k), k = 1 / sqrt(in), drawn from `generator`."""
    conv = nn.Conv1d(in_ch, out_ch, kernel_size=1)
    k = 1.0 / math.sqrt(in_ch)
    with torch.no_grad():
        conv.weight.uniform_(-k, k, generator=generator)
        conv.bias.uniform_(-k, k, generator=generator)
    return conv


def _pointwise(conv: nn.Conv1d, v):
    """The 1x1 conv over the region axis of (B, C, N), applied to (B, N, C):
    a Linear over the feature axis."""
    return F.linear(v, conv.weight[:, :, 0], conv.bias)


class RsGCN(nn.Module):
    """Region-relation non-local block (ref itr/modalmodule/vsrn_.py:6-71,
    itrx's RsGCN): g, theta, phi and W are 1x1 Conv1d over the regions,
    applied to (B, N, D) as Linears; W.1 is a BatchNorm whose scale and
    bias start at zero, so the block starts as the identity.  Keys g, theta,
    phi, W.0 and W.1 are the reference's."""

    def __init__(self, in_channels: int, inter_channels: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.g = _conv1x1(in_channels, inter_channels, generator)
        self.theta = _conv1x1(in_channels, inter_channels, generator)
        self.phi = _conv1x1(in_channels, inter_channels, generator)
        bn = TorchBatchNorm(in_channels)
        with torch.no_grad():
            bn.weight.zero_()
            bn.bias.zero_()
        self.W = nn.Sequential(_conv1x1(inter_channels, in_channels, generator), bn)

    def forward(self, v):
        n = v.shape[1]
        g_v = _pointwise(self.g, v)
        theta_v = _pointwise(self.theta, v)
        phi_v = _pointwise(self.phi, v)
        r = torch.matmul(theta_v, phi_v.transpose(1, 2)) / n
        y = torch.matmul(r, g_v)
        return self.W[1](_pointwise(self.W[0], y)) + v


class EncoderImagePrecompAttn(nn.Module):
    """VSRN's image tower (ref ImgEncoder.py:166-231): fc, four RsGCN
    blocks, l2norm over the REGION axis (the reference's l2norm defaults to
    dim 1, a quirk kept for checkpoint parity; before the blocks too, except
    on f30k), the region GRU `img_rnn` and its final state, then on f30k the
    dataset-conditional BatchNorm `bn`, l2norm and `use_abs`.  Returns
    (features (B, E), the GCN sequence (B, R, E), which feeds the caption
    decoder)."""

    def __init__(self, img_dim: int, embed_size: int, data_name: str = "f30k_precomp",
                 use_abs: bool = False, no_imgnorm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.data_name = data_name
        self.use_abs = use_abs
        self.no_imgnorm = no_imgnorm
        self.fc = xavier_linear(img_dim, embed_size, generator)
        for i in range(1, 5):
            setattr(self, f"Rs_GCN_{i}", RsGCN(embed_size, embed_size, generator))
        self.img_rnn = MaskedGRU(embed_size, embed_size, generator=generator)
        if data_name == "f30k_precomp":
            self.bn = TorchBatchNorm(embed_size)

    def forward(self, images):
        x = self.fc(images)
        if self.data_name != "f30k_precomp":
            x = l2norm(x, dim=1)
        for i in range(1, 5):
            x = getattr(self, f"Rs_GCN_{i}")(x)
        gcn_emb = l2norm(x, dim=1)
        ones = torch.ones(gcn_emb.shape[:2], dtype=torch.float32, device=gcn_emb.device)
        _, features = self.img_rnn(gcn_emb, ones)
        if self.data_name == "f30k_precomp":
            features = self.bn(features)
        if not self.no_imgnorm:
            features = l2norm(features, dim=-1)
        if self.use_abs:
            features = torch.abs(features)
        return features, gcn_emb
