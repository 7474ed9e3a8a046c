"""SCAN and SGRAF (counterparts of itrx/models/methods.py::SCAN: `embed`,
`similarity` and `loss`, t2i and i2t; and ::SGRAF with SAF: `embed` and
evaluation `similarity`)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import attention
from ..ops.kernels.xattn import xattn_i2t_fused, xattn_t2i_fused
from ..ops.losses import contrastive_hinge
from .img_encoders import EncoderImagePrecomp
from .sgraf import SGR_ITEM, EncoderSimilarity, training_not_ported
from .txt_encoders import EncoderText


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
        self.img_enc = EncoderImagePrecomp(img_dim, embed_size, no_imgnorm, generator)
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
        Mean) on a CUDA device.  Other variants, and training, take the plain path, as
        the JAX package sends them to its XLA path."""
        return (
            not train
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

    def loss(self, batch: dict, train: bool = True):
        """The training objective: (hinge loss on the in-batch grid,
        {"Loss": loss})."""
        e = self.embed(batch)
        scores = self.similarity(e["img"], e["cap"], e["cap_mask"], train=train)
        loss = contrastive_hinge(scores, self.margin, self.max_violation)
        return loss, {"Loss": loss}


class SGRAF(nn.Module):
    """SGRAF (ref Models.py:468-546) with the SAF module, in evaluation:
    region embeddings (B, 36, E), per-word embeddings of a bi-GRU (B, L, E),
    and the similarity tower `sim_enc` (models/sgraf.py).  SGR and training
    are not ported yet."""

    def __init__(self, vocab_size: int, img_dim: int = 2048, embed_size: int = 1024,
                 word_dim: int = 300, sim_dim: int = 256, bi_gru: bool = True,
                 no_imgnorm: bool = False, no_txtnorm: bool = False,
                 module_name: str = "SAF", cap_chunk: int = 32, sim_bf16: bool = False,
                 dropout: float = 0.4, generator: torch.Generator | None = None):
        super().__init__()
        if module_name == "SGR":
            raise NotImplementedError(
                f"SGRAF with module_name='SGR' is not ported yet: {SGR_ITEM}")
        if module_name != "SAF":
            raise ValueError(f"SGRAF module_name must be 'SGR' or 'SAF', got {module_name!r}")
        self.img_enc = EncoderImagePrecomp(img_dim, embed_size, no_imgnorm, generator)
        self.txt_enc = EncoderText(vocab_size, word_dim, embed_size, use_bi_gru=bi_gru,
                                   no_txtnorm=no_txtnorm, generator=generator)
        self.sim_enc = EncoderSimilarity(embed_size, sim_dim, cap_chunk=cap_chunk,
                                         sim_bf16=sim_bf16, dropout=dropout,
                                         generator=generator)

    def embed(self, batch: dict) -> dict:
        img = self.img_enc(batch["images"])
        cap = self.txt_enc(batch["cap_ids"], batch["cap_mask"])
        return {"img": img, "cap": cap, "cap_mask": batch["cap_mask"]}

    def forward(self, batch: dict) -> dict:
        return self.embed(batch)

    def fused_eval_active(self, device: torch.device, train: bool = False) -> bool:
        """True when `similarity` on tensors of `device` runs the CUDA
        kernel: evaluation (`not train`) on a CUDA device (the module is
        SAF: SGR is not ported)."""
        return not train and torch.device(device).type == "cuda"

    def similarity(self, img, cap, cap_mask, train: bool = False):
        if train:
            raise training_not_ported("SGRAF.similarity(train=True)")
        return self.sim_enc(img, cap, cap_mask,
                            kernel=self.fused_eval_active(img.device, train=train))
