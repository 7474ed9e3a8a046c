"""The BERT-text-tower methods' towers: SAEM's image branches
(TransformerMapping, FcMapping, CnnMapping, RnnMapping) and text branch
(BertMapping), and CAMERA's two towers (counterparts of
itrx/models/bert_methods.py).

Reference: itr/modalmodule/ImgEncoder.py:247-350 (SAEM's image branches),
:355-433 (CAMERA's image tower) and TextEncoder.py:74-197 (the two text
towers).  The text towers' BERT is frozen (ref TextEncoder.py:154-157): its
parameters take no gradient (so the optimizer, which takes only parameters
that require one, gives them no Adam state and no share of the clip), and it
runs under no_grad, so autograd keeps none of its activations.  Module names
give the reference's state-dict keys (`mapping`, `layer`, `convs1.{i}`,
`mapping_0`, `rnn`, `bert`), which `itrx.utils.ref_convert` reads.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import f_normalize, l2norm
from ..ops.rnn import MaskedGRU
from .agsa import AGSA, PositionEncoder, Summarization
from .bert import BertConfig, BertLayer, BertModel
from .layers import DropoutRNG, SeededDropout, TorchBatchNorm, torch_linear, xavier_linear

# the base config's `trans_cfg` names the JAX package's file; the port reads
# its own copy of it, beside configs/__init__.py
JAX_TRANS_CFG = "./itrx/configs/trans_cfg.json"
TRANS_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configs", "trans_cfg.json")


def default_trans_cfg(final_dims: int) -> BertConfig:
    """The transformer block used when the trans_cfg file is absent (the
    reference requires one it never ships; itrx's _default_trans_cfg): one
    self-attention block at the mapping width."""
    return BertConfig(vocab_size=30522, hidden_size=final_dims, num_hidden_layers=1,
                      num_attention_heads=4, intermediate_size=4 * final_dims,
                      hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def trans_config_from(config: dict) -> BertConfig:
    """SAEM's transformer block config: the file `config["trans_cfg"]` (the
    base config's default, the JAX package's file, read as the port's own
    copy TRANS_CFG; any other path as given) when it exists, else
    default_trans_cfg(final_dims)."""
    path = config.get("trans_cfg")
    if path and os.path.normpath(path) == os.path.normpath(JAX_TRANS_CFG):
        path = TRANS_CFG
    if path and os.path.exists(path):
        return BertConfig.from_json_file(path)
    return default_trans_cfg(config["final_dims"])


def _conv_bank(width: int, filters: int, generator) -> nn.ModuleList:
    """Conv2d(1, filters, (k, width)) for k = 1, 2, 3 (the reference's
    `convs1`) with torch's default init drawn from `generator`: weight and
    bias U(-b, b), b = 1 / sqrt(k width)."""
    convs = nn.ModuleList()
    for k in (1, 2, 3):
        conv = nn.Conv2d(1, filters, (k, width))
        b = 1.0 / math.sqrt(k * width)
        with torch.no_grad():
            conv.weight.uniform_(-b, b, generator=generator)
            conv.bias.uniform_(-b, b, generator=generator)
        convs.append(conv)
    return convs


def _conv_max(convs: nn.ModuleList, x):
    """(B, L, width) -> (B, 3 filters): each conv over the L axis (valid
    windows), ReLU, the max over every window (padded slots included)."""
    return torch.cat([torch.relu(conv(x[:, None])[..., 0]).amax(dim=2) for conv in convs],
                     dim=1)


def _mean_directions(out, h: int):
    """A bidirectional GRU's (B, L, 2H) outputs -> the mean of its two
    directions (B, L, H)."""
    return (out[..., :h] + out[..., h:]) / 2.0


class TransformerMapping(nn.Module):
    """SAEM's default image branch (ref ImgEncoder.py:324-350): `mapping`
    img_dim -> final_dims, one BertLayer `layer` over the regions (no mask),
    the mean over regions, unit norm."""

    def __init__(self, img_dim: int, trans_cfg: BertConfig, final_dims: int,
                 rng: DropoutRNG | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.mapping = torch_linear(img_dim, final_dims, generator=generator)
        self.layer = BertLayer(trans_cfg, generator, rng)

    def forward(self, images):
        x = self.mapping(images)
        attn_bias = torch.zeros(x.shape[0], 1, 1, x.shape[1], dtype=x.dtype, device=x.device)
        return f_normalize(self.layer(x, attn_bias).mean(dim=1), dim=1)


class FcMapping(nn.Module):
    """SAEM's `fc` image branch (ref ImgEncoder.py:247-265): `fc1`, the mean
    over regions, unit norm."""

    def __init__(self, img_dim: int, final_dims: int, generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = torch_linear(img_dim, final_dims, generator=generator)

    def forward(self, images):
        return f_normalize(self.fc1(images).mean(dim=1), dim=1)


class CnnMapping(nn.Module):
    """SAEM's `cnn` image branch (ref ImgEncoder.py:268-291): 256-filter
    convolutions of widths 1, 2, 3 over the regions `convs1`, ReLU, max,
    then `fc1` and unit norm."""

    def __init__(self, img_dim: int, final_dims: int, generator: torch.Generator | None = None):
        super().__init__()
        self.convs1 = _conv_bank(img_dim, 256, generator)
        self.fc1 = torch_linear(3 * 256, final_dims, generator=generator)

    def forward(self, images):
        return f_normalize(self.fc1(_conv_max(self.convs1, images)), dim=1)


class RnnMapping(nn.Module):
    """SAEM's `rnn` image branch (ref ImgEncoder.py:294-321, with the
    reference's float-slice bug fixed as `itrx` fixes it): a bidirectional
    GRU `rnn` of width final_dims over all regions, its two directions
    averaged, the mean over regions, unit norm."""

    def __init__(self, img_dim: int, final_dims: int, generator: torch.Generator | None = None):
        super().__init__()
        self.final_dims = final_dims
        self.rnn = MaskedGRU(img_dim, final_dims, bidirectional=True, generator=generator)

    def forward(self, images):
        ones = torch.ones(images.shape[:2], dtype=torch.float32, device=images.device)
        out, _ = self.rnn(images, ones)
        return f_normalize(_mean_directions(out, self.final_dims).mean(dim=1), dim=1)


class BertMapping(nn.Module):
    """SAEM's text branch (ref TextEncoder.py:74-157): the frozen BERT's
    last layer, then the `txt_stru` head: "cnn" (512-filter convolutions of
    widths 1, 2, 3 `convs1`, ReLU, the max over every slot), "pooling"
    (`mapping_0`, the mean over every slot), "rnn" (the masked GRU `rnn` of
    width embed_size, its two directions averaged when `bi_gru`, the mean
    over every slot, zero at the padded ones) or "trans" (`mapping_0` to the
    block's width, the BertLayer `layer` with the caption mask, the mean
    over every slot); then dropout at BERT's hidden_dropout_prob, `mapping`
    to final_dims, unit norm."""

    def __init__(self, bert_cfg: BertConfig, trans_cfg: BertConfig, final_dims: int,
                 embed_size: int, txt_stru: str = "cnn", bi_gru: bool = False,
                 rng: DropoutRNG | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.txt_stru = txt_stru
        self.embed_size = embed_size
        self.bi_gru = bi_gru
        self.bert = BertModel(bert_cfg, generator).requires_grad_(False)
        h = bert_cfg.hidden_size
        if txt_stru == "cnn":
            self.convs1 = _conv_bank(h, 512, generator)
            width = 3 * 512
        elif txt_stru == "pooling":
            self.mapping_0 = torch_linear(h, h, generator=generator)
            width = h
        elif txt_stru == "rnn":
            self.rnn = MaskedGRU(h, embed_size, bidirectional=bi_gru, generator=generator)
            width = embed_size
        elif txt_stru == "trans":
            self.mapping_0 = torch_linear(h, trans_cfg.hidden_size, generator=generator)
            self.layer = BertLayer(trans_cfg, generator, rng)
            width = trans_cfg.hidden_size
        else:
            raise ValueError(f"Unknown txt_stru: {txt_stru}")
        self.dropout = SeededDropout(bert_cfg.hidden_dropout_prob, rng)
        self.mapping = torch_linear(width, final_dims, generator=generator)

    def forward(self, input_ids, attention_mask, token_type_ids):
        with torch.no_grad():
            layers, _ = self.bert(input_ids, token_type_ids, attention_mask)
        x = layers[-1]
        if self.txt_stru == "cnn":
            out = _conv_max(self.convs1, x)
        elif self.txt_stru == "pooling":
            out = self.mapping_0(x).mean(dim=1)
        elif self.txt_stru == "rnn":
            out, _ = self.rnn(x, attention_mask.float())
            if self.bi_gru:
                out = _mean_directions(out, self.embed_size)
            out = out.mean(dim=1)
        else:
            bias = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
            out = self.layer(self.mapping_0(x), bias).mean(dim=1)
        return f_normalize(self.mapping(self.dropout(out)), dim=1)


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
