"""Image encoder over precomputed region features (counterpart of
itrx/models/img_encoders.py::EncoderImagePrecomp, the `basic` variant)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.norms import l2norm
from .layers import xavier_linear


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
