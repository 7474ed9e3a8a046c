"""The six methods (counterparts of itrx/models/methods.py::VSEPP on
precomputed features; ::SCAN, t2i and i2t; ::VSRN with the caption decoder;
::SGRAF with SGR or SAF; and itrx/models/bert_methods.py::SAEM and
::CAMERA), each with `embed`, `similarity` and `loss`."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import attention
from ..ops.kernels.xattn import xattn_i2t_fused, xattn_t2i_fused
from ..ops.losses import (angular_loss, contrastive_hinge, diversity_regularization,
                          language_model_loss, triplet_loss)
from ..ops.sim import cosine_sim, multi_view_matching, order_sim, pdist, pdist_cos
from .bert import BertConfig
from .bert_methods import (BertMapping, CAMERAImageEncoder, CAMERATextEncoder, CnnMapping,
                           FcMapping, RnnMapping, TransformerMapping)
from .img_encoders import EncoderImagePrecomp, EncoderImagePrecompAttn
from .layers import DropoutRNG
from .sgraf import EncoderSimilarity
from .txt_encoders import EncoderText
from .vsrn_decoder import S2VTAttModel


def sentence_grid(measure: str, img, cap):
    """The (Ni, Nc) fp32 grid of sentence-level (Ni, E) and (Nc, E)
    embeddings: order_sim with measure "order", else cosine_sim (VSE++ and
    VSRN)."""
    return order_sim(img, cap) if measure == "order" else cosine_sim(img, cap)


class VSEPP(nn.Module):
    """VSE++ on precomputed features (ref Models.py:63-144): one image
    embedding (B, E) from a Linear over the image's feature vector (B,
    img_dim), one caption embedding (B, E) from the GRU's output at the last
    word, l2-normalized (`no_txtnorm` False whatever the config says, as the
    reference passes it), both made absolute with `use_abs`; a cosine or
    order grid and the hinge loss on it."""

    def __init__(self, vocab_size: int, img_dim: int = 4096, embed_size: int = 1024,
                 word_dim: int = 300, measure: str = "cosine", use_abs: bool = False,
                 no_imgnorm: bool = False, margin: float = 0.2, max_violation: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if measure not in ("cosine", "order"):
            raise ValueError(f"VSE++ measure must be 'cosine' or 'order', got {measure!r}")
        self.measure = measure
        self.margin = margin
        self.max_violation = max_violation
        self.img_enc = EncoderImagePrecomp(img_dim, embed_size, no_imgnorm, generator,
                                           use_abs=use_abs)
        self.txt_enc = EncoderText(vocab_size, word_dim, embed_size, no_txtnorm=False,
                                   sentence_level=True, use_abs=use_abs, generator=generator)

    def embed(self, batch: dict) -> dict:
        img = self.img_enc(batch["images"])
        cap = self.txt_enc(batch["cap_ids"], batch["cap_mask"])
        return {"img": img, "cap": cap}

    def forward(self, batch: dict) -> dict:
        return self.embed(batch)

    def fused_eval_active(self, device: torch.device, train: bool = False) -> bool:
        """Always False: VSE++'s grid is one product; its kernel (the GRU)
        runs inside `embed`."""
        return False

    def similarity(self, img, cap, cap_mask=None, train: bool = False):
        return sentence_grid(self.measure, img, cap)

    def loss(self, batch: dict, train: bool = True, epoch: int = 0):
        """The training objective (itrx/models/methods.py:84-88): (hinge loss
        on the in-batch grid, {"Loss": loss}); `epoch` is unused."""
        e = self.embed(batch)
        loss = contrastive_hinge(self.similarity(e["img"], e["cap"]), self.margin,
                                 self.max_violation)
        return loss, {"Loss": loss}


class SCAN(nn.Module):
    """Stacked cross-attention: region embeddings (B, 36, E), per-word
    caption embeddings (B, L, E), a t2i or i2t score grid, and the hinge
    loss on the in-batch grid."""

    def __init__(self, vocab_size: int, img_dim: int = 2048, embed_size: int = 1024,
                 word_dim: int = 300, bi_gru: bool = False, no_imgnorm: bool = False,
                 no_txtnorm: bool = True, cross_attn: str = "t2i",
                 raw_feature_norm: str = "clipped_l2norm", agg_func: str = "LogSumExp",
                 lambda_lse: float = 6.0, lambda_softmax: float = 9.0,
                 margin: float = 0.2, max_violation: bool = False,
                 use_fused_eval: bool = True, precomp_enc_type: str = "basic",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cross_attn not in ("t2i", "i2t"):
            raise ValueError(f"SCAN cross_attn must be 't2i' or 'i2t', got {cross_attn!r}")
        self.cross_attn = cross_attn
        self.raw_feature_norm = raw_feature_norm
        self.agg_func = agg_func
        self.lambda_lse = lambda_lse
        self.lambda_softmax = lambda_softmax
        self.margin = margin
        self.max_violation = max_violation
        self.use_fused_eval = use_fused_eval
        self.img_enc = EncoderImagePrecomp(img_dim, embed_size, no_imgnorm, generator,
                                           precomp_enc_type=precomp_enc_type)
        self.txt_enc = EncoderText(vocab_size, word_dim, embed_size,
                                   use_bi_gru=bi_gru, no_txtnorm=no_txtnorm,
                                   generator=generator)

    def embed(self, batch: dict) -> dict:
        img = self.img_enc(batch["images"])
        cap = self.txt_enc(batch["cap_ids"], batch["cap_mask"])
        return {"img": img, "cap": cap, "cap_mask": batch["cap_mask"]}

    def forward(self, batch: dict) -> dict:
        return self.embed(batch)

    def fused_eval_active(self, device: torch.device, train: bool = False) -> bool:
        """True when `similarity` on tensors of `device` runs a CUDA kernel:
        evaluation (`not train`; the kernels have no backward) of the
        published t2i and i2t variants (clipped_l2norm with LogSumExp or
        Mean) on a CUDA device, unless `use_fused_eval` is off.  Other
        variants, and training, take the plain path, as the JAX package sends
        them to its XLA path."""
        return (
            self.use_fused_eval
            and not train
            and torch.device(device).type == "cuda"
            and self.raw_feature_norm == "clipped_l2norm"
            and self.agg_func in ("LogSumExp", "Mean")
        )

    def similarity(self, img, cap, cap_mask, train: bool = False):
        kw = dict(agg_func=self.agg_func, lambda_lse=self.lambda_lse,
                  lambda_softmax=self.lambda_softmax)
        t2i = self.cross_attn == "t2i"
        if self.fused_eval_active(img.device, train=train):
            fused = xattn_t2i_fused if t2i else xattn_i2t_fused
            return fused(img, cap, cap_mask, **kw)
        plain = attention.xattn_score_t2i if t2i else attention.xattn_score_i2t
        return plain(img, cap, cap_mask, raw_feature_norm=self.raw_feature_norm, **kw)

    def loss(self, batch: dict, train: bool = True, epoch: int = 0):
        """The training objective: (hinge loss on the in-batch grid,
        {"Loss": loss}).  `epoch` is unused (only SAEM's loss reads it)."""
        e = self.embed(batch)
        scores = self.similarity(e["img"], e["cap"], e["cap_mask"], train=train)
        loss = contrastive_hinge(scores, self.margin, self.max_violation)
        return loss, {"Loss": loss}


class VSRN(nn.Module):
    """VSRN (ref Models.py:229-365): the GCN image tower (B, E) and its
    region sequence, sentence-level captions (B, E) from the GRU over all
    max_len + 1 slots (the data's all-ones `cap_mask`, a quirk kept on
    purpose), a cosine or order grid, and the hinge loss plus the caption
    decoder's language-model loss.  Every dropout (the encoder's input, the
    decoder's words and context, at `input_dropout_p`) draws its masks from
    `dropout_rng`, seeded from `dropout_seed`."""

    def __init__(self, vocab_size: int, img_dim: int = 2048, embed_size: int = 2048,
                 word_dim: int = 300, data_name: str = "f30k_precomp",
                 measure: str = "cosine", use_abs: bool = False, no_imgnorm: bool = False,
                 no_txtnorm: bool = False, margin: float = 0.2, max_violation: bool = False,
                 max_len: int = 60, dim_hidden: int = 512, dim_vid: int = 2048,
                 dim_word: int = 300, input_dropout_p: float = 0.2, dropout_seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        if measure not in ("cosine", "order"):
            raise ValueError(f"VSRN measure must be 'cosine' or 'order', got {measure!r}")
        self.measure = measure
        self.margin = margin
        self.max_violation = max_violation
        self.dropout_rng = DropoutRNG(dropout_seed)
        self.img_enc = EncoderImagePrecompAttn(img_dim, embed_size, data_name, use_abs,
                                               no_imgnorm, generator)
        self.txt_enc = EncoderText(vocab_size, word_dim, embed_size, no_txtnorm=no_txtnorm,
                                   sentence_level=True, use_abs=use_abs, generator=generator)
        self.caption_model = S2VTAttModel(vocab_size, max_len, dim_vid, dim_hidden, dim_word,
                                          input_dropout_p, self.dropout_rng, generator)

    def embed(self, batch: dict) -> dict:
        """{"img", "cap"} (B, E) each, and in train mode "gcn", the region
        sequence that feeds the caption decoder (not kept in evaluation)."""
        img, gcn = self.img_enc(batch["images"])
        cap = self.txt_enc(batch["cap_ids"], batch["cap_mask"])
        out = {"img": img, "cap": cap}
        if self.training:
            out["gcn"] = gcn
        return out

    def forward(self, batch: dict) -> dict:
        return self.embed(batch)

    def fused_eval_active(self, device: torch.device, train: bool = False) -> bool:
        """Always False: VSRN's grid is one product (`itrx` computes it
        outside any kernel too)."""
        return False

    def similarity(self, img, cap, cap_mask=None, train: bool = False):
        return sentence_grid(self.measure, img, cap)

    def loss(self, batch: dict, train: bool = True, epoch: int = 0):
        """The training objective (itrx/models/methods.py:270-283): (hinge
        loss on the in-batch grid + the caption decoder's NLL, {"Loss",
        "Loss_retrieval", "Loss_caption"}).  `train` must agree with the
        module's mode (model.train()); `epoch` is unused."""
        if train != self.training:
            raise ValueError(
                f"VSRN.loss(train={train}) with the model in "
                f"{'train' if self.training else 'eval'} mode: call model.train() for "
                "training")
        e = self.embed(batch)
        retrieval = contrastive_hinge(self.similarity(e["img"], e["cap"]), self.margin,
                                      self.max_violation)
        logprobs = self.caption_model(e["gcn"], batch["label_ids"])
        caption = language_model_loss(logprobs, batch["label_ids"][:, 1:],
                                      batch["label_mask"][:, 1:])
        loss = retrieval + caption
        return loss, {"Loss": loss, "Loss_retrieval": retrieval, "Loss_caption": caption}


class SGRAF(nn.Module):
    """SGRAF (ref Models.py:468-546): region embeddings (B, 36, E),
    per-word embeddings of a bi-GRU (B, L, E) with dropout on the word
    vectors, the similarity tower `sim_enc` (models/sgraf.py) with the
    reasoning module `module_name`: "SGR" (`sgr_step` graph-reasoning
    steps) or "SAF", and the hinge loss on the in-batch grid.  Every dropout
    (the reference's 0.4, `dropout`) draws its masks from `dropout_rng`,
    seeded from `dropout_seed`."""

    def __init__(self, vocab_size: int, img_dim: int = 2048, embed_size: int = 1024,
                 word_dim: int = 300, sim_dim: int = 256, bi_gru: bool = True,
                 no_imgnorm: bool = False, no_txtnorm: bool = False,
                 module_name: str = "SAF", sgr_step: int = 3, cap_chunk: int = 32,
                 sim_bf16: bool = False, dropout: float = 0.4, margin: float = 0.2,
                 max_violation: bool = False, dropout_seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.margin = margin
        self.max_violation = max_violation
        self.dropout_rng = DropoutRNG(dropout_seed)
        self.img_enc = EncoderImagePrecomp(img_dim, embed_size, no_imgnorm, generator)
        self.txt_enc = EncoderText(vocab_size, word_dim, embed_size, use_bi_gru=bi_gru,
                                   no_txtnorm=no_txtnorm, dropout=dropout,
                                   dropout_rng=self.dropout_rng, generator=generator)
        self.sim_enc = EncoderSimilarity(embed_size, sim_dim, module_name=module_name,
                                         sgr_step=sgr_step, cap_chunk=cap_chunk,
                                         sim_bf16=sim_bf16, dropout=dropout,
                                         generator=generator, rng=self.dropout_rng)

    def embed(self, batch: dict) -> dict:
        img = self.img_enc(batch["images"])
        cap = self.txt_enc(batch["cap_ids"], batch["cap_mask"])
        return {"img": img, "cap": cap, "cap_mask": batch["cap_mask"]}

    def forward(self, batch: dict) -> dict:
        return self.embed(batch)

    def fused_eval_active(self, device: torch.device, train: bool = False) -> bool:
        """True when `similarity` on tensors of `device` runs the CUDA
        kernel of the reasoning module's evaluation (SGR's or SAF's):
        evaluation (`not train`) on a CUDA device, fp32 embeddings
        included.  Training reaches the alignment kernels instead, when
        `sim_bf16` (models/sgraf.py)."""
        return not train and torch.device(device).type == "cuda"

    def similarity(self, img, cap, cap_mask, train: bool = False):
        """The (Ni, Nc) grid.  `train` must agree with the module's mode
        (model.train() / model.eval()), which decides BatchNorm statistics
        and dropout: a mismatch raises rather than mixing the two."""
        if train != self.training:
            raise ValueError(
                f"SGRAF.similarity(train={train}) with the model in "
                f"{'train' if self.training else 'eval'} mode: call model.train() for "
                "training and model.eval() for evaluation")
        return self.sim_enc(img, cap, cap_mask,
                            kernel=self.fused_eval_active(img.device, train=train))

    def loss(self, batch: dict, train: bool = True, epoch: int = 0):
        """The training objective (itrx/models/methods.py:366-370): (hinge
        loss on the in-batch (Ni, Nc) grid, {"Loss": loss}); `epoch` is
        unused."""
        e = self.embed(batch)
        scores = self.similarity(e["img"], e["cap"], e["cap_mask"], train=train)
        loss = contrastive_hinge(scores, self.margin, self.max_violation)
        return loss, {"Loss": loss}


class CAMERA(nn.Module):
    """CAMERA (ref Models.py:550-645): smry_k view embeddings of each image
    (B, smry_k, D) from the position-gated AGSA image tower, one embedding
    of each caption (B, D) from the frozen BERT and the text AGSA, the grid
    of the best view of each image for each caption, and the triplet loss on
    the in-batch grid plus `smry_lamda` times the summarization's diversity
    term.  Every dropout (at `drop`) draws its masks from `dropout_rng`,
    seeded from `dropout_seed`; BERT's parameters take no gradient."""

    def __init__(self, bert_cfg: BertConfig, img_dim: int = 2048, embed_size: int = 2048,
                 head: int = 64, smry_k: int = 12, smry_lamda: float = 0.01,
                 drop: float = 0.0, margin: float = 0.2, max_violation: bool = False,
                 dropout_seed: int = 0, generator: torch.Generator | None = None):
        super().__init__()
        self.smry_lamda = smry_lamda
        self.margin = margin
        self.max_violation = max_violation
        self.dropout_rng = DropoutRNG(dropout_seed)
        self.img_enc = CAMERAImageEncoder(img_dim, embed_size, head, smry_k, drop,
                                          self.dropout_rng, generator)
        self.txt_enc = CAMERATextEncoder(bert_cfg, embed_size, head, drop, self.dropout_rng,
                                         generator)

    def embed(self, batch: dict) -> dict:
        """{"img": (B, smry_k, D), "cap": (B, D)}, and in train mode
        "smry_mat" (B, R, smry_k), which feeds only the diversity term (not
        kept in evaluation)."""
        cap = self.txt_enc(batch["cap_ids"], batch["cap_mask"], batch["type_ids"])
        img, smry_mat = self.img_enc(batch["images"], batch["boxes"], batch["imgs_wh"])
        out = {"img": img, "cap": cap}
        if self.training:
            out["smry_mat"] = smry_mat
        return out

    def forward(self, batch: dict) -> dict:
        return self.embed(batch)

    def fused_eval_active(self, device: torch.device, train: bool = False) -> bool:
        """Always False: CAMERA's grid is one product (`itrx` computes it
        outside any kernel too); its kernels run inside `embed`."""
        return False

    def similarity(self, img, cap, cap_mask=None, train: bool = False):
        """The (Ni, Nc) fp32 grid: each image's best view for each caption."""
        return multi_view_matching(img, cap)

    def loss(self, batch: dict, train: bool = True, epoch: int = 0):
        """The training objective (itrx/models/bert_methods.py:353-360):
        (ranking + smry_lamda x diversity, {"Loss", "Rank_Loss",
        "Div_loss"}).  `train` must agree with the module's mode
        (model.train()); `epoch` is unused."""
        if train != self.training:
            raise ValueError(
                f"CAMERA.loss(train={train}) with the model in "
                f"{'train' if self.training else 'eval'} mode: call model.train() for "
                "training")
        e = self.embed(batch)
        ranking = triplet_loss(self.similarity(e["img"], e["cap"]), self.margin,
                               self.max_violation)
        div = diversity_regularization(e["smry_mat"])
        loss = ranking + div * self.smry_lamda
        return loss, {"Loss": loss, "Rank_Loss": ranking, "Div_loss": div}


# the last names of SAEM's image-branch parameters that its weight penalty
# leaves out: `itrx` skips the leaves named bias, gamma, beta, b_ih and b_hh,
# so a bidirectional GRU's b_ih_reverse and b_hh_reverse stay in, as their
# port names bias_ih_l0_reverse and bias_hh_l0_reverse do here
_UNPENALIZED = ("bias", "gamma", "beta", "bias_ih_l0", "bias_hh_l0")


class SAEM(nn.Module):
    """SAEM (ref Models.py:369-464): one image embedding (B, final_dims)
    from the `img_stru` branch ("trans", "fc", "cnn" or "rnn"), one caption
    embedding (B, final_dims) from the frozen BERT and the `txt_stru` head
    (BertMapping), a cosine grid (`pdist_cos`) or, with measure "order",
    minus the euclidean distance, and the loss hinge + alpha x angular loss
    + the image branch's weight penalty.  Every dropout (the transformer
    blocks' and the text branch's) draws its masks from `dropout_rng`,
    seeded from `dropout_seed`; BERT's parameters take no gradient."""

    def __init__(self, bert_cfg: BertConfig, trans_cfg: BertConfig, img_dim: int = 2048,
                 final_dims: int = 256, embed_size: int = 1024, txt_stru: str = "cnn",
                 img_stru: str = "trans", bi_gru: bool = False, margin: float = 0.2,
                 max_violation: bool = False, measure: str = "cosine", dropout_seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.margin = margin
        self.max_violation = max_violation
        self.measure = measure
        self.dropout_rng = DropoutRNG(dropout_seed)
        if img_stru == "trans":
            self.img_enc = TransformerMapping(img_dim, trans_cfg, final_dims, self.dropout_rng,
                                              generator)
        elif img_stru == "fc":
            self.img_enc = FcMapping(img_dim, final_dims, generator)
        elif img_stru == "cnn":
            self.img_enc = CnnMapping(img_dim, final_dims, generator)
        elif img_stru == "rnn":
            self.img_enc = RnnMapping(img_dim, final_dims, generator)
        else:
            raise ValueError(f"Unknown img_stru: {img_stru}")
        self.txt_enc = BertMapping(bert_cfg, trans_cfg, final_dims, embed_size, txt_stru,
                                   bi_gru, self.dropout_rng, generator)

    def embed(self, batch: dict) -> dict:
        cap = self.txt_enc(batch["cap_ids"], batch["cap_mask"], batch["type_ids"])
        img = self.img_enc(batch["images"])
        return {"img": img, "cap": cap}

    def forward(self, batch: dict) -> dict:
        return self.embed(batch)

    def fused_eval_active(self, device: torch.device, train: bool = False) -> bool:
        """Always False: SAEM's grid is one product (`itrx` computes it
        outside any kernel too)."""
        return False

    def similarity(self, img, cap, cap_mask=None, train: bool = False):
        """The (Ni, Nc) fp32 grid: pdist_cos, or -pdist with measure
        "order"."""
        if self.measure == "order":
            return -pdist(img, cap)
        return pdist_cos(img, cap)

    def penalized(self) -> list:
        """The names of the image branch's parameters that the weight
        penalty sums (those whose last name is not in _UNPENALIZED)."""
        return [k for k, _ in self.img_enc.named_parameters()
                if k.rsplit(".", 1)[-1] not in _UNPENALIZED]

    def weight_reg(self):
        """0.01 x the sum of the Frobenius norms of `penalized()` (ref
        Models.py:433-439, itrx's _weight_reg)."""
        params = dict(self.img_enc.named_parameters())
        return 0.01 * sum(params[k].norm() for k in self.penalized())

    @staticmethod
    def alpha(epoch: int) -> float:
        """The angular loss's weight: 0.5 x 0.1^(epoch // 5), 0 past epoch
        20 (ref Models.py:419-442)."""
        return 0.0 if epoch > 20 else 0.5 * 0.1 ** (epoch // 5)

    def loss(self, batch: dict, train: bool = True, epoch: int = 0):
        """The training objective (itrx/models/bert_methods.py:240-251):
        (hinge + alpha(epoch) x angular_loss + weight_reg, {"Loss", "Loss1",
        "Loss2"}).  `train` must agree with the module's mode
        (model.train())."""
        if train != self.training:
            raise ValueError(
                f"SAEM.loss(train={train}) with the model in "
                f"{'train' if self.training else 'eval'} mode: call model.train() for "
                "training")
        e = self.embed(batch)
        loss1 = contrastive_hinge(self.similarity(e["img"], e["cap"]), self.margin,
                                  self.max_violation)
        loss2 = angular_loss(e["img"], e["cap"], 1.0, True)
        loss = loss1 + self.alpha(epoch) * loss2 + self.weight_reg()
        return loss, {"Loss": loss, "Loss1": loss1, "Loss2": loss2}
