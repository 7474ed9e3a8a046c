"""SGRAF similarity tower, evaluation and training with SGR or SAF
(counterpart of itrx/models/sgraf.py; reference Fusionmodule.py:373-629).

For caption c and image i the tower forms one node per valid word (the
SCAN attention context of the word over the 36 regions at lambda 9, its
squared difference with the word, `sim_tranloc_w`, l2norm) and a global node
(the squared difference of the two self-attended global embeddings,
`sim_tranglo_w`, l2norm).  SGR runs `sgr_step` graph-reasoning steps over
the nodes (`SGR_module`) and keeps the global node; SAF pools the nodes by
sigmoid-gated l1norm attention (`SAF_module`).  `sim_eval_w` + sigmoid
scores the result.

Module names are the reference PyTorch SGRAF's, so the state dict carries
its keys (`v_global_w.embedding_local.0.weight`, ...,
`SGR_module.sgr0.graph_query_w.weight`, `SAF_module.bn.running_var`;
itrx/utils/ref_convert.py:277-308 maps them).  The module's mode decides
the path: in eval mode the tower scores on running statistics (a CUDA
kernel per grid, or the plain chain); in train mode the heads' BatchNorms
take batch statistics, the 0.4 dropouts act, and each chunk of captions runs
SGR, or SAF with the per-caption BatchNorm statistics of the reference.
With `sim_bf16` the training chunk's word nodes come from
`sgraf_align_fused` and SGR's reasoning steps from `sgr_reason_fused` (the
CUDA kernels on the card), else both from the plain chain, as `itrx`
dispatches.

Arithmetic: the self-attention heads take their inputs in fp32 (their
parameters are fp32; the embeddings may arrive in bf16 from eval_bf16), and
the global embeddings they give are then rounded to the grid's dtype, so the
score reads the values the CUDA kernel reads.  The plain score chain runs in
fp32 on those values, the kernel's arithmetic; in training too, where the
bf16 word nodes of the alignment kernel are read back in fp32 and SGR's
steps run in fp32 on them (`itrx` runs that chain in bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.sgraf_align import sgraf_align_fused
from ..ops.kernels.sgraf_eval import fold_saf_bn, sgraf_eval_saf_fused, sgraf_eval_sgr_fused
from ..ops.kernels.sgr import sgr_reason_fused
from ..ops.norms import l1norm, l2norm, safe_sqrt
from .layers import DropoutRNG, SeededDropout, xavier_linear

NEG_INF = -1e18
EPS = 1e-8
LAMBDA_SOFTMAX = 9.0
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class VisualSA(nn.Module):
    """Global image embedding by region self-attention (ref :464-512).  The
    local branch's BatchNorm1d(num_region) normalizes per region (over the
    batch and the embedding); the Tanh and Dropout of the reference's
    Sequentials follow at indices 2-3.  In train mode the BatchNorms take
    batch statistics and update their running ones (torch's: unbiased
    variance, momentum 0.1), as `itrx`'s TorchBatchNorm does."""

    def __init__(self, embed_dim: int, num_region: int = 36, dropout_rate: float = 0.4,
                 generator: torch.Generator | None = None, rng: DropoutRNG | None = None):
        super().__init__()
        self.embedding_local = nn.Sequential(
            xavier_linear(embed_dim, embed_dim, generator), nn.BatchNorm1d(num_region),
            nn.Tanh(), SeededDropout(dropout_rate, rng))
        self.embedding_global = nn.Sequential(
            xavier_linear(embed_dim, embed_dim, generator), nn.BatchNorm1d(embed_dim),
            nn.Tanh(), SeededDropout(dropout_rate, rng))
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
                 generator: torch.Generator | None = None, rng: DropoutRNG | None = None):
        super().__init__()
        self.embedding_local = nn.Sequential(
            xavier_linear(embed_dim, embed_dim, generator), nn.Tanh(),
            SeededDropout(dropout_rate, rng))
        self.embedding_global = nn.Sequential(
            xavier_linear(embed_dim, embed_dim, generator), nn.Tanh(),
            SeededDropout(dropout_rate, rng))
        self.embedding_common = nn.Sequential(xavier_linear(embed_dim, 1, generator))

    def forward(self, local, raw_global, mask):
        l_emb = self.embedding_local(local)
        g_emb = self.embedding_global(raw_global)
        weights = self.embedding_common(l_emb * g_emb[:, None, :])[..., 0]
        weights = torch.softmax(weights.masked_fill(mask <= 0, NEG_INF), dim=1)
        return l2norm(torch.sum(weights[..., None] * local, dim=1), dim=-1)


class GraphReasoning(nn.Module):
    """One SGR step: self-attention over the alignment nodes (ref :564-597).
    The edge q k^T is masked to the valid nodes (keys), softmaxed over the
    keys, and the context goes through `sim_graph_w` and a ReLU."""

    def __init__(self, sim_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.graph_query_w = xavier_linear(sim_dim, sim_dim, generator)
        self.graph_key_w = xavier_linear(sim_dim, sim_dim, generator)
        self.sim_graph_w = xavier_linear(sim_dim, sim_dim, generator)

    def forward(self, sim_emb, node_mask):
        """sim_emb (B, N, S), node_mask (B, N) -> (B, N, S)."""
        edge = self.graph_query_w(sim_emb) @ self.graph_key_w(sim_emb).transpose(1, 2)
        edge = torch.softmax(edge.masked_fill(node_mask[:, None, :] <= 0, NEG_INF), dim=-1)
        return torch.relu(self.sim_graph_w(edge @ sim_emb))


class AttentionFiltration(nn.Module):
    """SAF: sigmoid-gated l1norm attention pooling over the nodes (ref
    :600-629).  In eval mode the single-channel BatchNorm runs on its
    running statistics.  In train mode it follows the reference, which
    scores one caption at a time (Fusionmodule.py:406-451): each caption's
    statistics over its Ni x (L_i + 1) valid nodes normalize its rows, and
    the running statistics take the C captions' updates in order, folded in
    closed form, r' = 0.9^C r + sum_i 0.1 0.9^(C-1-i) stat_i with the
    unbiased variance (itrx/models/sgraf.py:114-181).  `bn` stays an
    nn.BatchNorm1d(1), so the keys `SAF_module.bn.*` stay."""

    def __init__(self, sim_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.attn_sim_w = xavier_linear(sim_dim, 1, generator)
        self.bn = nn.BatchNorm1d(1)

    def _batch_norm(self, x, node_mask, cap_rows: int):
        """x, node_mask (B, N), rows grouped by caption, `cap_rows` captions
        -> x normalized by each caption's statistics; updates the running
        statistics (fp32)."""
        b, n = x.shape
        xc = x.float().reshape(cap_rows, b // cap_rows, n)
        mc = node_mask.float().reshape(cap_rows, b // cap_rows, n)
        cnt = mc.sum(dim=(1, 2))
        mean = (xc * mc).sum(dim=(1, 2)) / cnt
        var = (xc * xc * mc).sum(dim=(1, 2)) / cnt - mean * mean
        bn = self.bn
        with torch.no_grad():
            unbiased = var * (cnt / torch.clamp(cnt - 1.0, min=1.0))
            decay = 1.0 - BN_MOMENTUM
            w = BN_MOMENTUM * decay ** torch.arange(cap_rows - 1, -1, -1, dtype=torch.float32,
                                                     device=x.device)
            # in fp32, rounded once to the statistics' type (bf16 copies
            # under train_bf16)
            rm, rv = bn.running_mean, bn.running_var
            rm.copy_(rm.float() * decay ** cap_rows + (w * mean).sum())
            rv.copy_(rv.float() * decay ** cap_rows + (w * unbiased).sum())
            bn.num_batches_tracked.add_(cap_rows)
        # the normalization in x's dtype, as `itrx`'s
        dt = x.dtype
        out = (x.reshape(xc.shape) - mean.to(dt)[:, None, None]) \
            * torch.rsqrt(var + BN_EPS).to(dt)[:, None, None]
        return (out * bn.weight.to(dt) + bn.bias.to(dt)).reshape(b, n)

    def forward(self, sim_emb, node_mask, cap_rows: int = 1):
        """sim_emb (B, N, S), node_mask (B, N) -> (B, S).  In train mode the
        B rows are `cap_rows` captions' rows, caption-major."""
        x = self.attn_sim_w(sim_emb)[..., 0]  # (B, N)
        if self.training:
            attn = self._batch_norm(x, node_mask, cap_rows)
        else:
            attn = self.bn(x[:, None])[:, 0]
        attn = l1norm(torch.sigmoid(attn) * node_mask, dim=-1)
        return l2norm(torch.einsum("bn,bnd->bd", attn, sim_emb), dim=-1)


def _norm(x, dim: int):
    """l2 normalization as x * 1 / (sqrt(sum x^2) + eps) (the JAX package's
    `_norm` of the score chain): the squares summed in fp32, the scale in
    x's dtype."""
    sq = torch.sum((x * x).float(), dim=dim, keepdim=True)
    return x * (1.0 / (safe_sqrt(sq) + EPS)).to(x.dtype)


class EncoderSimilarity(nn.Module):
    """SGRAF image-text similarity (ref :373-451) with SGR or SAF, in eval
    and in train mode.

    `forward(img (Ni, R, D), cap (Nc, L, D), cap_mask (Nc, L), kernel)`
    returns the (Ni, Nc) fp32 grid: with `kernel`, one call of the module's
    CUDA kernel wrapper; else the plain chain over chunks of `cap_chunk`
    captions, whose (chunk, Ni, L, D) context bounds its memory.  The grid
    reads the embeddings in bf16 when `sim_bf16`, else in their own dtype.
    """

    def __init__(self, embed_size: int, sim_dim: int, module_name: str = "SAF",
                 sgr_step: int = 3, cap_chunk: int = 32, sim_bf16: bool = False,
                 dropout: float = 0.4, generator: torch.Generator | None = None,
                 rng: DropoutRNG | None = None):
        super().__init__()
        if module_name not in ("SGR", "SAF"):
            raise ValueError(f"SGRAF module_name must be 'SGR' or 'SAF', got {module_name!r}")
        if module_name == "SGR" and sgr_step < 1:
            raise ValueError(f"SGRAF sgr_step must be at least 1, got {sgr_step}")
        self.module_name = module_name
        self.cap_chunk = cap_chunk
        self.sim_bf16 = sim_bf16
        self.v_global_w = VisualSA(embed_size, dropout_rate=dropout, generator=generator,
                                   rng=rng)
        self.t_global_w = TextSA(embed_size, dropout, generator, rng)
        self.sim_tranloc_w = xavier_linear(embed_size, sim_dim, generator)
        self.sim_tranglo_w = xavier_linear(embed_size, sim_dim, generator)
        self.sim_eval_w = xavier_linear(sim_dim, 1, generator)
        if module_name == "SGR":
            self.SGR_module = nn.ModuleDict(
                {f"sgr{i}": GraphReasoning(sim_dim, generator) for i in range(sgr_step)})
        else:
            self.SAF_module = AttentionFiltration(sim_dim, generator)

    def _compute_dtype(self, dt: torch.dtype) -> torch.dtype:
        """The chains' arithmetic: values of type `dt` meet the weights in
        their promoted type, as in the JAX package: fp32 with fp32 weights,
        bf16 when both are (train_bf16 casts the weights)."""
        return torch.promote_types(dt, self.sim_eval_w.weight.dtype)

    def global_embeddings(self, img, cap, cap_mask):
        """(img_glo (Ni, D), cap_glo (Nc, D)), in the compute dtype.  The
        region mean and the masked word mean are taken in the embeddings'
        dtype, as in the JAX package (its mask is cast to that dtype, so a
        bf16 stack stays bf16)."""
        ct = self._compute_dtype(img.dtype)
        img_ave = img.mean(dim=1)
        denom = torch.clamp(cap_mask.float().sum(dim=1, keepdim=True), min=1.0)
        cap_ave = (cap * cap_mask.to(cap.dtype)[..., None]).sum(dim=1) / denom.to(cap.dtype)
        img_glo = self.v_global_w(img.to(ct), img_ave.to(ct))
        cap_glo = self.t_global_w(cap.to(ct), cap_ave.to(ct), cap_mask.to(ct))
        return img_glo, cap_glo

    def _module_weights(self) -> tuple:
        """The reasoning module's weights as its kernel wrapper takes them:
        SGR's per-step Linears stacked (wq, bq, wk, bk, wg, bg); SAF's gate
        with the BatchNorm folded in (awf, abf)."""
        if self.module_name == "SGR":
            steps = list(self.SGR_module.values())
            return tuple(torch.stack([getattr(getattr(m, lin), part) for m in steps])
                         for lin in ("graph_query_w", "graph_key_w", "sim_graph_w")
                         for part in ("weight", "bias"))
        saf = self.SAF_module
        return fold_saf_bn(saf.attn_sim_w.weight, saf.attn_sim_w.bias, saf.bn.weight,
                           saf.bn.bias, saf.bn.running_mean, saf.bn.running_var)

    def forward(self, img, cap, cap_mask, kernel: bool = False):
        """In eval mode the (Ni, Nc) grid on running statistics; in train
        mode the training grid (`kernel` must be False there: with `sim_bf16`
        the word nodes go to the alignment kernels and SGR's steps to the
        reasoning kernels)."""
        if self.training and kernel:
            raise ValueError("the SGRAF eval kernels score evaluation only; in train mode "
                             "the word nodes go to sgraf_align_fused and SGR's steps to "
                             "sgr_reason_fused")
        dt = torch.bfloat16 if self.sim_bf16 else img.dtype
        img_glo, cap_glo = self.global_embeddings(img, cap, cap_mask)
        if kernel:
            fused = sgraf_eval_sgr_fused if self.module_name == "SGR" else sgraf_eval_saf_fused
            return fused(
                cap.to(dt), cap_mask, img.to(dt),
                self.sim_tranloc_w.weight, self.sim_tranloc_w.bias,
                cap_glo.to(dt), img_glo.to(dt),
                self.sim_tranglo_w.weight, self.sim_tranglo_w.bias, *self._module_weights(),
                self.sim_eval_w.weight, self.sim_eval_w.bias,
            ).t()
        # the plain chain: fp32 on the grid dtype's values, or bf16 with
        # bf16 weights (train_bf16)
        ct = self._compute_dtype(dt)
        on_grid = lambda t: t.to(dt).to(ct)  # noqa: E731
        img, img_glo, cap_glo = on_grid(img), on_grid(img_glo), on_grid(cap_glo)
        cap, mask = on_grid(cap), cap_mask.to(ct)
        blocks = [
            self._score_chunk(img, img_glo, cap[c0:c0 + self.cap_chunk],
                              mask[c0:c0 + self.cap_chunk], cap_glo[c0:c0 + self.cap_chunk])
            for c0 in range(0, cap.shape[0], self.cap_chunk)
        ]
        return torch.cat(blocks, dim=1)

    def _score_chunk(self, img, img_glo, cap, mask, cap_glo):
        """(Ni, C) scores of one caption chunk (ref :406-451, 632-664): the
        pair-batched SCAN attention, the alignment nodes, SGR (every step on
        every node, node 0 kept) or SAF, and the sim_eval_w epilogue.  In
        train mode with `sim_bf16` the word nodes come from the alignment
        kernels' wrapper on the bf16 values (zero at masked words, which SAF
        weighs zero and SGR's softmax masks), read back in fp32, and SGR's
        steps from the reasoning kernels' wrapper in fp32 (zero at masked
        nodes; node 0 is kept), as `itrx` routes its bf16 chain to its SGR
        kernel (itrx/models/sgraf.py:436-459); the rest is the same fp32
        chain.  The SAF BatchNorm takes this chunk's per-caption
        statistics."""
        c, l = mask.shape
        ni = img.shape[0]
        if self.training and self.sim_bf16:
            bf = torch.bfloat16
            sim_loc = sgraf_align_fused(cap.to(bf), mask, img.to(bf), self.sim_tranloc_w.weight,
                                        self.sim_tranloc_w.bias).to(cap.dtype)
        else:
            a = torch.einsum("ird,cld->cirl", img, cap)  # (C, Ni, R, L)
            a = _norm(F.leaky_relu(a, negative_slope=0.1) * mask[:, None, None, :], dim=3)
            attn = torch.softmax(a.transpose(2, 3) * LAMBDA_SOFTMAX, dim=3)  # (C, Ni, L, R)
            ctx = _norm(torch.einsum("cilr,ird->cild", attn, img), dim=-1)
            sim_loc = _norm(self.sim_tranloc_w((ctx - cap[:, None]) ** 2), dim=-1)
        sim_glo = l2norm(self.sim_tranglo_w((img_glo[None] - cap_glo[:, None]) ** 2), dim=-1)
        sim_emb = torch.cat([sim_glo[:, :, None], sim_loc], dim=2).reshape(c * ni, l + 1, -1)
        node_mask = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1)
        node_mask = node_mask[:, None].expand(c, ni, l + 1).reshape(c * ni, l + 1)
        if self.module_name == "SGR":
            if self.training and self.sim_bf16:
                sim_emb = sgr_reason_fused(sim_emb, node_mask, *self._module_weights())
            else:
                for step in self.SGR_module.values():
                    sim_emb = step(sim_emb, node_mask)
            sim_vec = sim_emb[:, 0]
        else:
            sim_vec = self.SAF_module(sim_emb, node_mask, cap_rows=c)
        return torch.sigmoid(self.sim_eval_w(sim_vec).float())[:, 0].reshape(c, ni).t()
