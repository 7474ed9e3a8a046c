"""GRU caption encoder (counterpart of itrx/models/txt_encoders.py::EncoderText)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.norms import l2norm
from ..ops.rnn import MaskedGRU
from .layers import DropoutRNG, SeededDropout, torch_embedding


class EncoderText(nn.Module):
    """Embedding -> dropout -> masked (bi)GRU.  Returns per-word embeddings
    (B, L, H), the two directions of a bi-GRU averaged, or with
    `sentence_level` the output at each caption's last valid word;
    l2-normalized unless `no_txtnorm`.  `dropout` (SGRAF's 0.4; 0 for SCAN) acts on the word
    embeddings in train mode, its masks from `dropout_rng`.  Submodules
    `embed` and `rnn` give the reference's state-dict keys."""

    def __init__(self, vocab_size: int, word_dim: int, embed_size: int,
                 use_bi_gru: bool = False, no_txtnorm: bool = False,
                 sentence_level: bool = False, dropout: float = 0.0,
                 dropout_rng: DropoutRNG | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.embed_size = embed_size
        self.use_bi_gru = use_bi_gru
        self.no_txtnorm = no_txtnorm
        self.sentence_level = sentence_level
        self.embed = torch_embedding(vocab_size, word_dim, generator)
        self.dropout = SeededDropout(dropout, dropout_rng)
        self.rnn = MaskedGRU(word_dim, embed_size, bidirectional=use_bi_gru,
                             generator=generator)

    def forward(self, cap_ids, cap_mask):
        x = self.dropout(self.embed(cap_ids))
        out, _ = self.rnn(x, cap_mask)
        if self.use_bi_gru:
            h = self.embed_size
            out = (out[..., :h] + out[..., h:]) / 2.0
        if self.sentence_level:
            last = cap_mask.sum(dim=-1).long() - 1
            cap_emb = out[torch.arange(out.shape[0], device=out.device), last]
        else:
            cap_emb = out
        if not self.no_txtnorm:
            cap_emb = l2norm(cap_emb, dim=-1)
        return cap_emb
