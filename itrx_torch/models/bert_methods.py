"""CAMERA's two towers (counterpart of itrx/models/bert_methods.py::
CAMERAImageEncoder and ::CAMERATextEncoder).

Reference: itr/modalmodule/ImgEncoder.py:355-433 (the image tower) and
TextEncoder.py:162-197 (the text tower).  The text tower's BERT is frozen
(ref TextEncoder.py:154-157): its parameters take no gradient (so the
optimizer, which takes only parameters that require one, gives them no Adam
state and no share of the clip), and it runs under no_grad, so autograd
keeps none of its activations.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.norms import f_normalize, l2norm
from .agsa import AGSA, PositionEncoder, Summarization
from .bert import BertConfig, BertModel
from .layers import DropoutRNG, SeededDropout, TorchBatchNorm, torch_linear, xavier_linear


class CAMERAImageEncoder(nn.Module):
    """fc -> l2norm over regions -> position-gated AGSA -> l2norm over
    regions -> multi-view summarization -> smry_k view embeddings.  Returns
    ((B, smry_k, D) views, each unit-norm, and the (B, R, smry_k)
    summarization matrix)."""

    def __init__(self, img_dim: int, embed_size: int, head: int, smry_k: int,
                 drop: float = 0.0, rng: DropoutRNG | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc = xavier_linear(img_dim, embed_size, generator)
        self.position_enc = PositionEncoder(embed_size, generator)
        self.agsa = AGSA(1, embed_size, h=head, drop=drop, rng=rng, generator=generator)
        self.mvs = Summarization(embed_size, smry_k, generator)

    def forward(self, images, boxes, imgs_wh):
        # the reference's l2norm defaults to dim 1: on (B, R, D) it normalizes
        # over the REGION axis (ImgEncoder.py:378,383)
        fc_emb = l2norm(self.fc(images), dim=1)
        posi = self.position_enc(boxes, imgs_wh)
        att = l2norm(self.agsa(fc_emb, pos_emb=posi), dim=1)
        smry_mat = self.mvs(att)
        weights = torch.softmax(smry_mat, dim=1)  # over regions
        views = torch.einsum("brk,brd->bkd", weights, att)
        return f_normalize(views, dim=-1), smry_mat


class CAMERATextEncoder(nn.Module):
    """The frozen BERT's last layer -> `mapping` -> AGSA -> fc1, ReLU, fc2,
    the BatchNorm `bn` as a residual -> the mean over every token slot (the
    padded ones too, as the reference means them) -> unit norm (B, D)."""

    def __init__(self, bert_cfg: BertConfig, embed_size: int, head: int, drop: float = 0.0,
                 rng: DropoutRNG | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.bert = BertModel(bert_cfg, generator).requires_grad_(False)
        self.mapping = torch_linear(bert_cfg.hidden_size, embed_size, generator=generator)
        self.agsa = AGSA(1, embed_size, h=head, drop=drop, rng=rng, generator=generator)
        self.fc1 = torch_linear(embed_size, embed_size, generator=generator)
        self.fc2 = torch_linear(embed_size, embed_size, generator=generator)
        self.bn = TorchBatchNorm(embed_size)
        self.dropout = SeededDropout(drop, rng)

    def forward(self, input_ids, attention_mask, token_type_ids):
        with torch.no_grad():
            layers, _ = self.bert(input_ids, token_type_ids, attention_mask)
        x = self.mapping(layers[-1])
        b, t, d = x.shape
        agsa_emb = self.agsa(x)
        y = self.fc2(self.dropout(torch.relu(self.fc1(agsa_emb))))
        y = self.bn(y.reshape(b * t, d)).reshape(b, t, d)
        x = agsa_emb + self.dropout(y)
        return f_normalize(x.mean(dim=1), dim=-1)
