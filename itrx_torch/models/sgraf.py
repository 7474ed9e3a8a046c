"""SGRAF similarity tower, evaluation with SAF (counterpart of
itrx/models/sgraf.py; reference Fusionmodule.py:373-629).

For caption c and image i the tower forms one node per valid word (the
SCAN attention context of the word over the 36 regions at lambda 9, its
squared difference with the word, `sim_tranloc_w`, l2norm) and a global node
(the squared difference of the two self-attended global embeddings,
`sim_tranglo_w`, l2norm), pools the nodes by SAF (sigmoid-gated l1norm
attention, `SAF_module`), and scores the pooled vector with `sim_eval_w` +
sigmoid.

Module names are the reference PyTorch SGRAF's, so the state dict carries
its keys (`v_global_w.embedding_local.0.weight`, ..., `SAF_module.bn.
running_var`; itrx/utils/ref_convert.py:277-308 maps them).  Only
evaluation is ported: SGR (`module_name="SGR"`) and training, whose SAF
BatchNorm takes per-caption statistics, raise, naming their ROADMAP items.

Arithmetic: the self-attention heads take their inputs in fp32 (their
parameters are fp32; the embeddings may arrive in bf16 from eval_bf16), and
the global embeddings they give are then rounded to the grid's dtype, so the
score reads the values the CUDA kernel reads.  The plain score chain runs in
fp32 on those values, the kernel's arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.sgraf_eval import fold_saf_bn, sgraf_eval_saf_fused
from ..ops.norms import l1norm, l2norm, safe_sqrt
from .layers import xavier_linear

NEG_INF = -1e18
EPS = 1e-8
LAMBDA_SOFTMAX = 9.0
SGR_ITEM = "ROADMAP queue 1 item 8b"
TRAIN_ITEM = "ROADMAP queue 1 item 8c"


def training_not_ported(what: str):
    return NotImplementedError(
        f"{what}: SGRAF training is not ported yet (the SAF BatchNorm's per-caption "
        f"train statistics come with it): {TRAIN_ITEM}")


class VisualSA(nn.Module):
    """Global image embedding by region self-attention (ref :464-512).  The
    local branch's BatchNorm1d(num_region) normalizes per region; the Tanh
    and Dropout of the reference's Sequentials follow at indices 2-3."""

    def __init__(self, embed_dim: int, num_region: int = 36, dropout_rate: float = 0.4,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.embedding_local = nn.Sequential(
            xavier_linear(embed_dim, embed_dim, generator), nn.BatchNorm1d(num_region),
            nn.Tanh(), nn.Dropout(dropout_rate))
        self.embedding_global = nn.Sequential(
            xavier_linear(embed_dim, embed_dim, generator), nn.BatchNorm1d(embed_dim),
            nn.Tanh(), nn.Dropout(dropout_rate))
        self.embedding_common = nn.Sequential(xavier_linear(embed_dim, 1, generator))

    def forward(self, local, raw_global):
        l_emb = self.embedding_local(local)
        g_emb = self.embedding_global(raw_global)
        weights = self.embedding_common(l_emb * g_emb[:, None, :])[..., 0]
        weights = torch.softmax(weights, dim=1)
        return l2norm(torch.sum(weights[..., None] * local, dim=1), dim=-1)


class TextSA(nn.Module):
    """Global text embedding by word self-attention (ref :515-561), its
    softmax masked to the caption's words."""

    def __init__(self, embed_dim: int, dropout_rate: float = 0.4,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.embedding_local = nn.Sequential(
            xavier_linear(embed_dim, embed_dim, generator), nn.Tanh(), nn.Dropout(dropout_rate))
        self.embedding_global = nn.Sequential(
            xavier_linear(embed_dim, embed_dim, generator), nn.Tanh(), nn.Dropout(dropout_rate))
        self.embedding_common = nn.Sequential(xavier_linear(embed_dim, 1, generator))

    def forward(self, local, raw_global, mask):
        l_emb = self.embedding_local(local)
        g_emb = self.embedding_global(raw_global)
        weights = self.embedding_common(l_emb * g_emb[:, None, :])[..., 0]
        weights = torch.softmax(weights.masked_fill(mask <= 0, NEG_INF), dim=1)
        return l2norm(torch.sum(weights[..., None] * local, dim=1), dim=-1)


class AttentionFiltration(nn.Module):
    """SAF: sigmoid-gated l1norm attention pooling over the nodes (ref
    :600-629), in evaluation: the single-channel BatchNorm on its running
    statistics."""

    def __init__(self, sim_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.attn_sim_w = xavier_linear(sim_dim, 1, generator)
        self.bn = nn.BatchNorm1d(1)

    def forward(self, sim_emb, node_mask, train: bool = False):
        """sim_emb (B, N, S), node_mask (B, N) -> (B, S)."""
        if train or self.training:
            raise training_not_ported("AttentionFiltration(train=True)")
        attn = self.bn(self.attn_sim_w(sim_emb).transpose(1, 2))[:, 0]  # (B, N)
        attn = l1norm(torch.sigmoid(attn) * node_mask, dim=-1)
        return l2norm(torch.einsum("bn,bnd->bd", attn, sim_emb), dim=-1)


def _norm(x, dim: int):
    """l2 normalization as x * 1 / (sqrt(sum x^2) + eps) (the JAX package's
    `_norm` of the score chain)."""
    return x * (1.0 / (safe_sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + EPS))


class EncoderSimilarity(nn.Module):
    """SGRAF-SAF image-text similarity (ref :373-451), evaluation only.

    `forward(img (Ni, R, D), cap (Nc, L, D), cap_mask (Nc, L), kernel)`
    returns the (Ni, Nc) fp32 grid: with `kernel`, one call of the CUDA
    kernel's wrapper; else the plain chain over chunks of `cap_chunk`
    captions, whose (chunk, Ni, L, D) context bounds its memory.  The grid
    reads the embeddings in bf16 when `sim_bf16`, else in their own dtype.
    """

    def __init__(self, embed_size: int, sim_dim: int, cap_chunk: int = 32,
                 sim_bf16: bool = False, dropout: float = 0.4,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cap_chunk = cap_chunk
        self.sim_bf16 = sim_bf16
        self.v_global_w = VisualSA(embed_size, dropout_rate=dropout, generator=generator)
        self.t_global_w = TextSA(embed_size, dropout, generator)
        self.sim_tranloc_w = xavier_linear(embed_size, sim_dim, generator)
        self.sim_tranglo_w = xavier_linear(embed_size, sim_dim, generator)
        self.sim_eval_w = xavier_linear(sim_dim, 1, generator)
        self.SAF_module = AttentionFiltration(sim_dim, generator)

    def global_embeddings(self, img, cap, cap_mask):
        """(img_glo (Ni, D), cap_glo (Nc, D)), fp32.  The region mean and the
        masked word mean are taken in the embeddings' dtype, as in the JAX
        package (its mask is cast to that dtype, so a bf16 stack stays bf16)."""
        img_ave = img.mean(dim=1)
        denom = torch.clamp(cap_mask.float().sum(dim=1, keepdim=True), min=1.0)
        cap_ave = (cap * cap_mask.to(cap.dtype)[..., None]).sum(dim=1) / denom.to(cap.dtype)
        img_glo = self.v_global_w(img.float(), img_ave.float())
        cap_glo = self.t_global_w(cap.float(), cap_ave.float(), cap_mask)
        return img_glo, cap_glo

    def forward(self, img, cap, cap_mask, kernel: bool = False):
        if self.training:
            raise training_not_ported("EncoderSimilarity in training mode")
        dt = torch.bfloat16 if self.sim_bf16 else img.dtype
        img_glo, cap_glo = self.global_embeddings(img, cap, cap_mask)
        if kernel:
            saf = self.SAF_module
            awf, abf = fold_saf_bn(saf.attn_sim_w.weight, saf.attn_sim_w.bias, saf.bn.weight,
                                   saf.bn.bias, saf.bn.running_mean, saf.bn.running_var)
            return sgraf_eval_saf_fused(
                cap.to(dt), cap_mask, img.to(dt),
                self.sim_tranloc_w.weight, self.sim_tranloc_w.bias,
                cap_glo.to(dt), img_glo.to(dt),
                self.sim_tranglo_w.weight, self.sim_tranglo_w.bias, awf, abf,
                self.sim_eval_w.weight, self.sim_eval_w.bias,
            ).t()
        # the plain chain: fp32 on the grid dtype's values
        on_grid = lambda t: t.to(dt).float()  # noqa: E731
        img, img_glo, cap_glo = on_grid(img), on_grid(img_glo), on_grid(cap_glo)
        cap, mask = on_grid(cap), cap_mask.float()
        blocks = [
            self._score_chunk(img, img_glo, cap[c0:c0 + self.cap_chunk],
                              mask[c0:c0 + self.cap_chunk], cap_glo[c0:c0 + self.cap_chunk])
            for c0 in range(0, cap.shape[0], self.cap_chunk)
        ]
        return torch.cat(blocks, dim=1)

    def _score_chunk(self, img, img_glo, cap, mask, cap_glo):
        """(Ni, C) scores of one caption chunk (ref :406-451, 632-664): the
        pair-batched SCAN attention, the alignment nodes, SAF and the
        sim_eval_w epilogue."""
        c, l = mask.shape
        ni = img.shape[0]
        a = torch.einsum("ird,cld->cirl", img, cap)  # (C, Ni, R, L)
        a = _norm(F.leaky_relu(a, negative_slope=0.1) * mask[:, None, None, :], dim=3)
        attn = torch.softmax(a.transpose(2, 3) * LAMBDA_SOFTMAX, dim=3)  # (C, Ni, L, R)
        ctx = _norm(torch.einsum("cilr,ird->cild", attn, img), dim=-1)
        sim_loc = _norm(self.sim_tranloc_w((ctx - cap[:, None]) ** 2), dim=-1)
        sim_glo = l2norm(self.sim_tranglo_w((img_glo[None] - cap_glo[:, None]) ** 2), dim=-1)
        sim_emb = torch.cat([sim_glo[:, :, None], sim_loc], dim=2).reshape(c * ni, l + 1, -1)
        node_mask = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1)
        node_mask = node_mask[:, None].expand(c, ni, l + 1).reshape(c * ni, l + 1)
        sim_vec = self.SAF_module(sim_emb, node_mask)
        return torch.sigmoid(self.sim_eval_w(sim_vec))[:, 0].reshape(c, ni).t()
