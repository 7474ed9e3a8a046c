"""VSRN's caption-decoder head, teacher forcing (training) only
(counterpart of itrx/models/vsrn_decoder.py; ref itr/modalmodule/
Fusionmodule.py: S2VTAttModel :10-34, Attention :112-146, EncoderRNN
:149-203, DecoderRNN :206-367).

The module names and layouts are the reference's, so the state dict has the
keys `itrx.utils.ref_convert.convert_vsrn_caption` reads: encoder.vid2hid,
encoder.rnn.*, decoder.embedding, decoder.attention.linear1 / linear2,
decoder.rnn.* (a GRU cell over [word | context]) and decoder.out.  Every
dropout draws its masks from the model's DropoutRNG.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels.vsrn_dec import vsrn_dec_fused
from ..ops.rnn import MaskedGRU
from .layers import DropoutRNG, SeededDropout, torch_embedding, torch_linear, xavier_normal_linear

# greedy and multinomial caption sampling (VSRN.caption) are not ported yet
SAMPLING_ITEM = "ROADMAP queue 1 item 16 (VSRN caption sampling)"


def _check_mode(mode: str) -> None:
    if mode in ("greedy", "multinomial"):
        raise NotImplementedError(f"VSRN caption sampling (mode={mode!r}) is not ported "
                                  f"yet: {SAMPLING_ITEM}")
    if mode != "train":
        raise ValueError(f"Unknown decode mode: {mode}")


class EncoderRNN(nn.Module):
    """vid2hid (dim_vid -> dim_hidden), dropout, then a GRU over the regions:
    (outputs (B, R, H), final state (B, H))."""

    def __init__(self, dim_vid: int, dim_hidden: int, input_dropout_p: float = 0.2,
                 rng: DropoutRNG | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.vid2hid = xavier_normal_linear(dim_vid, dim_hidden, generator)
        self.dropout = SeededDropout(input_dropout_p, rng)
        self.rnn = MaskedGRU(dim_hidden, dim_hidden, generator=generator)

    def forward(self, vid_feats):
        x = self.dropout(self.vid2hid(vid_feats))
        ones = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
        return self.rnn(x, ones)


class Attention(nn.Module):
    """Additive attention's weights: linear1 (2H -> H) over [encoder | decoder
    state], linear2 (H -> 1, no bias).  Applied by DecoderRNN, which hoists
    the encoder half out of the decode loop."""

    def __init__(self, dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.linear1 = torch_linear(2 * dim, dim, generator=generator)
        self.linear2 = torch_linear(dim, 1, bias=False, generator=generator)


class DecoderRNN(nn.Module):
    """The attention decoder in teacher forcing: log-probs (B, max_len - 1,
    V) of the next words of `targets`.

    As in `itrx`, the word half of the GRU's input projection (with b_ih),
    the encoder half of the attention (enc_out linear1[:, :H]^T + b1) and
    the vocab projection are products outside the loop; the loop (attention,
    context dropout, GRU cell) is `vsrn_dec_fused`, the hand-written kernels
    on the card.  Word dropout and the context-dropout masks of all steps
    (drawn up front, as `itrx`'s kernel route draws them) use the rate
    `input_dropout_p`."""

    def __init__(self, vocab_size: int, max_len: int, dim_hidden: int, dim_word: int,
                 input_dropout_p: float = 0.1, rng: DropoutRNG | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_len = max_len
        self.dim_hidden = dim_hidden
        self.dim_word = dim_word
        self.embedding = torch_embedding(vocab_size, dim_word, generator)
        self.attention = Attention(dim_hidden, generator)
        self.rnn = MaskedGRU(dim_word + dim_hidden, dim_hidden, generator=generator)
        self.out = xavier_normal_linear(dim_hidden, vocab_size, generator)
        self.word_dropout = SeededDropout(input_dropout_p, rng)
        self.context_dropout = SeededDropout(input_dropout_p, rng)

    def forward(self, encoder_outputs, encoder_hidden, targets=None, mode: str = "train"):
        _check_mode(mode)
        t, hd, wd = self.max_len - 1, self.dim_hidden, self.dim_word
        words = self.word_dropout(self.embedding(targets[:, :t]))
        w_ih = self.rnn.weight_ih_l0
        gxw = (torch.matmul(words, w_ih[:, :wd].t()) + self.rnn.bias_ih_l0).transpose(0, 1)
        w1 = self.attention.linear1.weight
        enc_att = torch.matmul(encoder_outputs, w1[:, :hd].t()) + self.attention.linear1.bias
        cmask = self.context_dropout.mask((t, words.shape[0], hd), words.device)
        hs = vsrn_dec_fused(gxw.contiguous(), cmask, encoder_outputs.contiguous(),
                            enc_att.contiguous(), encoder_hidden.contiguous(), w1[:, hd:],
                            self.attention.linear2.weight, w_ih[:, wd:], self.rnn.weight_hh_l0,
                            self.rnn.bias_hh_l0)
        logprobs = torch.log_softmax(self.out(hs), dim=-1)  # (T, B, V)
        return logprobs.transpose(0, 1)


class S2VTAttModel(nn.Module):
    """The encoder and the decoder (ref Fusionmodule.py:10-34): region
    features (B, R, dim_vid) and caption ids -> log-probs (B, max_len - 1,
    V)."""

    def __init__(self, vocab_size: int, max_len: int, dim_vid: int = 2048,
                 dim_hidden: int = 512, dim_word: int = 300, input_dropout_p: float = 0.2,
                 rng: DropoutRNG | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = EncoderRNN(dim_vid, dim_hidden, input_dropout_p, rng, generator)
        self.decoder = DecoderRNN(vocab_size, max_len, dim_hidden, dim_word, input_dropout_p,
                                  rng, generator)

    def forward(self, vid_feats, targets=None, mode: str = "train"):
        _check_mode(mode)
        enc_out, enc_hidden = self.encoder(vid_feats)
        return self.decoder(enc_out, enc_hidden, targets, mode=mode)
