"""SCAN (counterpart of itrx/models/methods.py::SCAN: `embed`,
`similarity` and `loss`)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import attention
from ..ops.kernels.xattn import xattn_t2i_fused
from ..ops.losses import contrastive_hinge
from .img_encoders import EncoderImagePrecomp
from .txt_encoders import EncoderText


class SCAN(nn.Module):
    """Stacked cross-attention: region embeddings (B, 36, E), per-word
    caption embeddings (B, L, E), a t2i score grid, and the hinge loss on
    the in-batch grid."""

    def __init__(self, vocab_size: int, img_dim: int = 2048, embed_size: int = 1024,
                 word_dim: int = 300, bi_gru: bool = False, no_imgnorm: bool = False,
                 no_txtnorm: bool = True, cross_attn: str = "t2i",
                 raw_feature_norm: str = "clipped_l2norm", agg_func: str = "LogSumExp",
                 lambda_lse: float = 6.0, lambda_softmax: float = 9.0,
                 margin: float = 0.2, max_violation: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cross_attn != "t2i":
            raise NotImplementedError(
                f"SCAN cross_attn={cross_attn!r}: only t2i is ported; i2t is "
                "ROADMAP queue 2 item 4 (xattn.py::_kernel_i2t)"
            )
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
        """True when `similarity` on tensors of `device` runs the CUDA kernel:
        evaluation (`not train`; the kernel has no backward) of the
        published t2i variants (clipped_l2norm with LogSumExp or Mean) on a
        CUDA device.  Other variants, and training, take the plain path, as
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
        if self.fused_eval_active(img.device, train=train):
            return xattn_t2i_fused(img, cap, cap_mask, **kw)
        return attention.xattn_score_t2i(
            img, cap, cap_mask, raw_feature_norm=self.raw_feature_norm, **kw
        )

    def loss(self, batch: dict, train: bool = True):
        """The training objective: (hinge loss on the in-batch grid,
        {"Loss": loss})."""
        e = self.embed(batch)
        scores = self.similarity(e["img"], e["cap"], e["cap_mask"], train=train)
        loss = contrastive_hinge(scores, self.margin, self.max_violation)
        return loss, {"Loss": loss}
