#!/usr/bin/env python3
"""Drive the PyTorch port of itrx once on an NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA (there is no CPU fallback), prints the card's name
   and power limit, and turns TF32 off so fp32 comparisons are real fp32;
2. build: compiles the kernels of itrx_torch/csrc with nvcc for sm_90a, one
   nvcc per source, all started together;
3. kernel vs plain: each kernel's wrapper against its plain PyTorch version
   on the same inputs on the card, at the main paths' widths and at ragged
   sizes, with stated tolerances, and each one's time beside the plain
   version's, its bound (bytes or operations at the H100's data-sheet
   rates) and, for the GRU kernels, cuDNN's GRU (CUDA events, after
   warm-up).  The GRU adjoint is held to autograd through the plain GRU
   (all five gradients, both directions); the SGRAF-SAF and SGRAF-SGR score
   kernels to `sgraf_eval_saf_plain` and `sgraf_eval_sgr_plain` at D 1024,
   S 256 (SGR at sgr_step 3, and 1 at the ragged shape), bf16 and fp32,
   and SGR at a 128-word caption and at S 128 in bf16; the SGRAF training
   alignment kernels (forward and backward) to `sgraf_align_plain` and
   `sgraf_align_bwd_plain` (all four gradients, and two backward calls
   bit-identical) at one training chunk, 32 captions x 128 images x 24
   words, and at a ragged odd shape, bf16 and fp32; the SGR training
   reasoning kernels to `sgr_reason_plain` and `sgr_reason_bwd_plain`
   (the final nodes, all seven cotangents, dbk identically 0, two backward
   calls bit-identical) at one training chunk, 4096 pairs x 25 nodes,
   S 256, sgr_step 3, at a ragged odd shape and at 129 nodes, fp32 and bf16;
   VSRN's caption-decoder kernels to `vsrn_dec_plain` and
   `vsrn_dec_bwd_plain` (the states and residuals, all nine cotangents, two
   backward calls bit-identical) at the training path's decode, 59 steps x
   128 x 36 regions, H 512, without and with the context dropout, and at a
   ragged odd shape; CAMERA's AGSA gated attention kernel to
   `agsa_attention_plain` at both towers' calls on the evaluation path (128
   x 64 heads x 36 regions or 32 BERT slots x d_k 32), at a ragged odd shape
   and at the largest shape its limits allow (N 64, d_k 128), bf16 and
   fp32; and the GRU kernels at VSRN's text width (H 2048, 61 steps) against
   autograd through the plain GRU;
4. the evaluation slices at full width on an f30k-1K-shaped synthetic split
   (1000 images x 36 x 2048 regions, 5000 captions) through get_model ->
   evaluate_split (encode_data -> cal_sims -> cal_recall) with encode_bf16
   and eval_bf16, weights from torch.Generator().manual_seed(0): SCAN t2i
   LSE (bench.py's), SCAN's published i-t AVG (bi_gru, Mean,
   lambda_softmax 4), SGRAF-SAF (the SGRAF() overlay: bi_gru, embed 1024,
   sim_dim 256) and SGRAF-SGR (the same with module_name=SGR, sgr_step 3).
   The launch counters show which kernels ran (and that no other kernel
   did).  The phases are then timed one by one and must
   reproduce evaluate_split's ranks.  The witness: the bf16
   kernel grid must match the plain fp32 grid on the same embeddings (max
   abs diff <= the slice's limit) and rank like it (per-caption top-1
   agreement >= 0.95, with >= 2 distinct top-1 images).  Then the CAMERA
   slice (the CAMERA() overlay: embed 2048, 64 heads, smry_k 12, BERT-base
   with the split's tiny vocabulary, max_words 32, boxes and image sizes
   from the synthetic split): the counters show agsa_attn once a tower and
   batch (80) and no other kernel; its witnesses are an fp32 encode through
   the kernel against the same encode through agsa_attention_plain on the
   card (embeddings and grid within 1e-5, top-1 agreement >= 0.95) and the
   bf16 main path's grid against that fp32 grid (at limits set from the
   first reading on the card);
5. the ensembles: a t2i LSE and an i-t AVG checkpoint with random weights
   through evalrank_ensemble, whose ranks must be cal_recall of the two
   averaged grids; SGRAF's published protocol, the SGR and SAF slices'
   models as checkpoints through evalrank_ensemble, whose ranks must be
   cal_recall of the average of the two slices' grids; then fold5 on a
   coco-testall-shaped split (5000 images, 25000 captions) through
   evalrank_ensemble(..., fold5=True): each fold's recall must be that of
   its own averaged grid, Mean_metrics the mean of the five parts;
6. the training slice at full width: SCAN's published f30k t2i training
   configuration (bi_gru, max_violation, batch 128, embed 1024, 36 x 2048
   regions, Adam 2e-4, clip 2.0, fp32) for one epoch of a synthetic split
   (50 steps) through itrx_torch.train.loop.fit, with one validation and
   checkpoint mid-epoch and one at its end.  The launch counters show that
   the GRU forward, the GRU adjoint and (in validation) xattn ran; every
   loss is finite and the loss falls; evalrank_single on model_best.pth.tar
   reproduces its best_rsum; the first step's loss and every gradient on the
   card match the same step on a CPU copy of the model (the plain path).
   Then the median step time and a profile of a few steps;
7. the SGRAF-SAF training slice at full width: SGRAF's published f30k SAF
   command (the SGRAF() overlay with max_violation: bi-GRU, embed 1024,
   sim_dim 256, batch 128, Adam 2e-4, clip 2.0) with sim_bf16, one 25-step
   epoch through fit with validation mid-epoch and at the end: the
   counters show the GRU kernels, both alignment kernels (4 launches each a
   step) and, in validation, the SAF eval kernel, and no SCAN or SGR grid
   kernel; the losses are finite and fall; evalrank_single reproduces
   best_rsum; the first step at dropout 0 (loss, every gradient, the SAF and
   visual BatchNorm running statistics) matches a CPU copy.  Then the
   median step time, samples/s, peak memory and a profile of 3 steps;
8. the SGRAF-SGR training slice, the same with SGRAF's published f30k SGR
   command (`module_name=SGR sgr_step=3`): the counters show both
   alignment kernels and both reasoning kernels, 4 launches each a step,
   and the SGR eval kernel in validation; the first-step witness also holds
   the card's step to the same step with the chunk kernels swapped for
   their plain pairs on the card;
9. the VSRN training slice: VSRN's published f30k command (the VSRN()
   overlay with max_violation, lr_update 10, max_len 60: embed 2048,
   dim_hidden 512, 36 x 2048 regions, 61 caption slots, batch 128, Adam
   2e-4, clip 2.0, fp32), one 25-step epoch through fit with validation at
   step 15 and the end: the counters show the GRU kernels (text, region and
   the decoder's encoder) and both decoder kernels, once each a step, and no
   grid kernel; the first step at input_dropout_p 0, with the RsGCN blocks
   moved off the identity, matches a CPU copy (loss, every gradient, every
   BatchNorm statistic).

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from itrx_torch.configs import parse_cli
from itrx_torch.data.precomp import get_loaders, get_test_loader
from itrx_torch.data.synthetic import generate, write_tiny_bert_vocab
from itrx_torch.eval import engine, metrics
from itrx_torch.models import get_model
from itrx_torch.models import agsa as agsa_model
from itrx_torch.models import sgraf as sgraf_model
from itrx_torch.models.layers import TorchBatchNorm
from itrx_torch.ops import kernels
from itrx_torch.ops.kernels import gru as kgru
from itrx_torch.ops.kernels.gru import gru_bwd_fused, gru_scan_fused
from itrx_torch.ops.kernels import vsrn_dec as kvsrn
from itrx_torch.ops.kernels.agsa_attn import agsa_attention_fused, agsa_attention_plain
from itrx_torch.ops.kernels.sgr import (sgr_reason_bwd_fused, sgr_reason_bwd_plain,
                                        sgr_reason_fused, sgr_reason_plain)
from itrx_torch.ops.kernels.sgraf_align import (sgraf_align_bwd_fused, sgraf_align_bwd_plain,
                                                sgraf_align_fused, sgraf_align_plain)
from itrx_torch.ops.kernels.sgraf_eval import (sgraf_eval_saf_fused, sgraf_eval_saf_plain,
                                               sgraf_eval_sgr_fused, sgraf_eval_sgr_plain)
from itrx_torch.ops.kernels.vsrn_dec import (vsrn_dec_bwd_fused, vsrn_dec_bwd_plain,
                                             vsrn_dec_fused, vsrn_dec_plain)
from itrx_torch.ops.kernels.xattn import (xattn_i2t_fused, xattn_i2t_plain,
                                          xattn_t2i_fused, xattn_t2i_plain)
from itrx_torch.ops.rnn import gru_bwd_plain, gru_fwd_plain, gru_scan
from itrx_torch.train.loop import fit, make_train_step, prefetch
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint, load_state_list, save_checkpoint

REPO = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda", 0)
TOP1_MIN = 0.95
# Kernel vs plain tolerances.  Each plain side computes on the very values
# the kernel reads (bf16 inputs upcast; for the GRU's bf16 mode, the carry
# rounded to bf16 before the recurrent product as the kernel rounds it), so
# the two differ by fp32 summation order only, and each limit sits one to
# two orders above that, far below a one-chunk or wrong-operand fault
# (whose error is of the order of the scores' spread over images, ~1e-2).
GRU_FP32_ATOL = 1e-5
GRU_BF16_ATOL = 1e-4  # also bf16 rounding flips of the carry
XATTN_FP32_ATOL = 1e-6
XATTN_BF16_ATOL = 1e-5
# SGRAF-SAF scores are sigmoids whose spread over images is ~1e-3 with
# random weights: the limit is two orders above the summation-order error
# measured on the H100 (~1e-7) and two under that spread
SAF_FP32_ATOL = 1e-5
SAF_BF16_ATOL = 1e-5
# SGRAF-SGR: the same scores' scale and spread; the kernel sums the node
# projections, the reasoning products and the edges in another order than the
# plain chain, all in fp32
SGR_FP32_ATOL = 1e-5
SGR_BF16_ATOL = 1e-5
SLICE_MAX_DIFF = 1e-5  # bf16 kernel grid vs the fp32 plain grid on its values
# GRU adjoint (fp32): max|g_kernel - g_plain| / max|g_plain| per tensor.  The
# two sides differ by fp32 summation order through 48 steps; a gradient that
# loses one timestep's cotangent is printed beside each reading and must
# exceed the limit.
GRU_BWD_REL = 1e-5
# training witness, card vs CPU copy (fp32, plain path on the CPU): the loss
# (relative) and every parameter's gradient (max abs error over the tensor's
# largest entry); the attention chain (softmax at lambda 9, LogSumExp at 6)
# amplifies summation-order differences to ~1e-5 of a tensor's scale
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-3
# BatchNorm running statistics after the first step (SGRAF), relative to
# the larger of the tensor's largest entry and its channels' standard
# deviation: forward values in another summation order
TRAIN_STAT_REL = 1e-4
# SGRAF-SAF with sim_bf16: both devices round the word nodes and their
# cotangents to bf16 (one step is 2^-8 of an entry), and an entry whose fp32
# value sits near a rounding boundary may round apart; measured on the H100
# up to 8.8e-4 of a gradient's scale
TRAIN_GRAD_REL_BF16 = 1e-2
# SGRAF-SGR with sim_bf16: the three reasoning steps amplify those rounding
# flips further.  Measured on the H100 (the witness's own attribution): the
# same plain chain on the card and on the CPU 1.4e-2 of a gradient's scale
# (the embedding and GRU weights, step 1's sim_graph_w), the card's kernels
# against their plain pairs on the card, in the same step, 2.6e-3; so the
# card is held to the CPU within TRAIN_GRAD_REL_SGR and to its own plain
# chain within SGR_KERNEL_GRAD_REL
TRAIN_GRAD_REL_SGR = 3e-2
SGR_KERNEL_GRAD_REL = 1e-2
# biases whose gradient is zero in exact arithmetic (before a per-feature
# BatchNorm, or a softmax): rounding noise on both devices, held to this
# share of the model's largest gradient entry instead
ZERO_GRADS = ("sim_enc.v_global_w.embedding_global.0.bias",
              "sim_enc.v_global_w.embedding_common.0.bias",
              "sim_enc.t_global_w.embedding_common.0.bias",
              "sim_enc.SAF_module.attn_sim_w.bias") + tuple(
    f"sim_enc.SGR_module.sgr{i}.graph_key_w.bias" for i in range(3)) + tuple(
    # VSRN: each RsGCN block's W.0 conv feeds a train-mode BatchNorm
    f"img_enc.Rs_GCN_{i}.W.0.bias" for i in range(1, 5))
ZERO_GRAD_REL = 1e-4
TRAIN_STEPS = 50  # one epoch of the synthetic train split at batch 128
TRAIN_VAL_STEP = 30  # one validation + checkpoint mid-epoch, one at the end
# SGRAF-SAF training: one epoch of 25 steps, validation at step 15 and the end
SAF_TRAIN_STEPS = 25
SAF_TRAIN_VAL_STEP = 15
# SGRAF's training chunks a step: batch 128 / cap_chunk 32
SGRAF_CHUNKS = 4
# the alignment kernels vs their plain pair on the same inputs: the forward's
# nodes (l2-normalized, entries up to ~0.3) in fp32 differ by summation order
# only; in bf16 both sides round the same fp32 node to bf16, so they may sit
# one bf16 step (2^-9 at 0.25) apart
ALIGN_FP32_ATOL = 1e-5
ALIGN_BF16_ATOL = 2e-3
# the backward, per gradient max|kernel - plain| / max|plain|: summation
# order through the chain, amplified at one-word captions (whose word norm is
# a sign, h / (|h| + eps): measured on the CPU 5e-5 of gcap's scale between
# fp32 and float64); gcap and gimg in bf16 are rounded to bf16 on both sides,
# which may put them one bf16 step (2^-8 of an entry) apart.  A gradient that
# loses one caption's contribution is printed beside each reading and must
# exceed the limit
ALIGN_BWD_REL = 1e-3
ALIGN_BWD_BF16_REL = 2.0 ** -8
# (Nc, Ni, L): one training chunk at full width (cap_chunk 32 x batch 128,
# caption bound 24), then a ragged odd shape (Nc not a multiple of the
# caption group, Ni odd, a one-word caption, L 21)
ALIGN_SHAPES = ((32, 128, 24), (37, 37, 21))
# the SGR reasoning kernels vs their plain pair on the same inputs (fp32
# arithmetic on both sides, bf16 nodes read as they are): the final nodes
# (relu outputs, entries up to ~1) differ by summation order only, through
# sgr_step steps; the backward's seven cotangents, per tensor
# max|kernel - plain| over the larger of its largest entry and SGR_FLOOR of
# the largest entry of the seven (the later steps' q/k gradients are the
# small remainder of a cancellation over near-uniform edges, whose rounding
# is that of the cancelling terms).  A gradient that loses one pair's
# cotangent is printed beside each reading and must exceed the limit
SGR_FWD_REL = 1e-5
SGR_BWD_REL = 1e-4
SGR_FLOOR = 1e-3
# bf16 nodes give bf16 final nodes and a bf16 g_s0, rounded on both sides,
# which may put them one bf16 step (2^-8 of an entry) apart
SGR_BF16_REL = 2.0 ** -8
# (pairs, L, sgr_step, S): one training chunk (cap_chunk 32 x batch 128,
# caption bound 24, the published sgr_step 3 and sim_dim 256), a ragged odd
# shape (odd pairs, a one-word caption, N = 22 nodes, sgr_step 1), and the
# longest caption the kernels take (128 words, 129 nodes) at S 128
SGR_SHAPES = ((32 * 128, 24, 3, 256), (185, 21, 1, 256), (64, 128, 2, 128))
# VSRN's decoder kernels vs their plain pair on the same inputs (fp32 on both
# sides): the states and the residuals, and each of the nine cotangents, per
# tensor max|kernel - plain| / max|plain|; the two differ by fp32 summation
# order through the T steps.  A gradient that loses the second step's
# cotangent is printed beside each reading and must exceed the limit
VSRN_FWD_REL = 1e-5
VSRN_BWD_REL = 1e-4
# (T, B, R, H, keep of the context dropout): the training path's decode (max_len
# 60, batch 128, 36 regions, dim_hidden 512) without and with its 0.2
# dropout, then a ragged odd shape
VSRN_DEC_SHAPES = ((59, 128, 36, 512, 1.0), (59, 128, 36, 512, 0.8), (7, 37, 5, 96, 0.5))
VSRN_DEC_NAMES = ("g_gxw", "g_cmask", "g_enc_out", "g_enc_att", "g_h0", "dWatt", "dw2",
                  "dWctx", "dWhh", "dbhh")
# CAMERA's AGSA gated attention kernel vs its plain version on the same
# inputs (the plain version rounds where the kernel rounds), per output
# max|kernel - plain| / max|plain|: fp32 outputs differ by fp32 summation
# order; bf16 outputs are rounded on both sides, and an intermediate near a
# rounding boundary may put them one bf16 step (2^-8 of the output's scale)
# apart.  The plain output with fc_g's two halves swapped (a wrong-operand
# fault) is printed beside each reading and must exceed the limit
AGSA_FP32_REL = 1e-5
AGSA_BF16_REL = 2.0 ** -8
# (B, h, N, d_k): the image and text towers' calls on CAMERA's eval path (the
# CAMERA() overlay: encode batch 128, 64 heads, 36 regions or 32 BERT slots,
# embed 2048), a ragged odd shape and the largest shape the limits allow
AGSA_SHAPES = ((128, 64, 36, 32), (128, 64, 32, 32), (5, 3, 7, 8), (4, 2, 64, 128))
# the CAMERA slice's first witness: an fp32 encode through the kernel vs the
# same encode through agsa_attention_plain on the card (unit-norm
# embeddings; the two differ by fp32 summation order in the attention)
CAMERA_FP32_ATOL = 1e-5
# the second witness: the bf16 main path's grid (bf16 BERT, towers and
# kernel, bf16 embeddings) against the fp32 kernel grid of the same weights.
# Read on an H100 80GB HBM3 at 700 W, this slice's first run: max diff
# 9.2e-4, top-1 agreement 0.963 (random weights leave the scores 1.7e-2
# apart on average over images, so near-ties flip); the limits sit 5x above
# the difference and below the agreement
CAMERA_BF16_GRID_ATOL = 5e-3
CAMERA_BF16_TOP1_MIN = 0.9
REPLACES = {
    "gru": "itrx/ops/pallas/gru.py:37 (_fwd_kernel)",
    "gru_bwd": "itrx/ops/pallas/gru.py:68 (_bwd_kernel)",
    "xattn": "itrx/ops/pallas/xattn.py:43 (_kernel)",
    "xattn_i2t": "itrx/ops/pallas/xattn.py:228 (_kernel_i2t)",
    "sgraf_eval_saf": "itrx/ops/pallas/sgraf_eval.py:190 (_eval_saf_kernel)",
    "sgraf_eval_sgr": "itrx/ops/pallas/sgraf_eval.py:171 (_eval_kernel)",
    "sgraf_align": "itrx/ops/pallas/sgraf_align.py:102 (_fwd_kernel)",
    "sgraf_align_bwd": "itrx/ops/pallas/sgraf_align.py:112 (_bwd_kernel)",
    "sgr": "itrx/ops/pallas/sgr.py:78 (_fwd_kernel)",
    "sgr_bwd": "itrx/ops/pallas/sgr.py:91 (_bwd_kernel)",
    "vsrn_dec": "itrx/ops/pallas/vsrn_dec.py:79 (_fwd_kernel)",
    "vsrn_dec_bwd": "itrx/ops/pallas/vsrn_dec.py:103 (_bwd_kernel)",
    "agsa_attn": "itrx/ops/pallas/agsa_attn.py:64 (_fwd_kernel)",
}
SOURCES = {"gru": "gru.cu", "gru_bwd": "gru_bwd.cu", "xattn": "xattn.cu",
           "xattn_i2t": "xattn_i2t.cu", "sgraf_eval_saf": "sgraf_eval_saf.cu",
           "sgraf_eval_sgr": "sgraf_eval_sgr.cu", "sgraf_align": "sgraf_align.cu",
           "sgraf_align_bwd": "sgraf_align_bwd.cu", "sgr": "sgr.cu", "sgr_bwd": "sgr_bwd.cu",
           "vsrn_dec": "vsrn_dec.cu", "vsrn_dec_bwd": "vsrn_dec_bwd.cu",
           "agsa_attn": "agsa_attn.cu"}
COUNTERS = {"gru": gru_scan_fused, "gru_bwd": gru_bwd_fused, "xattn": xattn_t2i_fused,
            "xattn_i2t": xattn_i2t_fused, "sgraf_eval_saf": sgraf_eval_saf_fused,
            "sgraf_eval_sgr": sgraf_eval_sgr_fused, "sgraf_align": sgraf_align_fused,
            "sgraf_align_bwd": sgraf_align_bwd_fused, "sgr": sgr_reason_fused,
            "sgr_bwd": sgr_reason_bwd_fused, "vsrn_dec": vsrn_dec_fused,
            "vsrn_dec_bwd": vsrn_dec_bwd_fused, "agsa_attn": agsa_attention_fused}
# PR 6's SAF kernel at 64 x 320 x 36 x 24 x 1024, S 256 (ms, bf16 and fp32;
# NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
SAF_PR6_MS = (12.642, 18.232)
# a slice grid slower than this is timed once, not best of 3
ONE_TIMING_S = 5.0
# SCAN's published i-t settings (kuanghuei/SCAN README): i-t AVG (the eval
# slice) is agg_func=Mean lambda_softmax=4; i-t LSE adds lambda_lse=5
I2T_SOFTMAX = 4.0
I2T_LSE = 5.0
# bounds: the least time an H100 SXM could take (NVIDIA's data sheet, dense,
# at the 700 W limit): bytes over the HBM rate, operations over the peak of
# their type; the larger of the two
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
# fold5: coco testall, 5 folds of 1000 images x 5000 captions
FOLD5_MEAN_ATOL = 1e-9  # the mean of the parts, summed in another order


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(name: str, got, want, atol: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = float((got.float() - want.float()).abs().max())
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol:g})")
    if not err <= atol:
        raise AssertionError(f"{name}: max_abs_err {err} > atol {atol}")
    return err


def bound(n_bytes: float, ops: dict) -> dict:
    """{"bound_ms", "bound_by"}: bytes moved once over the HBM rate against
    operations over the peak rate of their type (ops: {type: count}; units of
    different types may run at once, so the slowest type bounds)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n / PEAK_OPS_PER_S[k] for k, n in ops.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cudnn_gru(w_ih, w_hh, b_ih, b_hh, dtype):
    """torch.nn.GRU (cuDNN) holding the same weights, in `dtype`: the
    library yardstick of the GRU kernels (timed here, used nowhere in the
    port)."""
    h3, d = w_ih.shape
    m = torch.nn.GRU(d, h3 // 3, batch_first=True).to(DEV)
    with torch.no_grad():
        for name, w in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh),
                        ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
            getattr(m, name).copy_(w)
    m = m.to(dtype)
    m.flatten_parameters()
    return m


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU and has no CPU fallback", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def check_rel(name: str, got, want, limit: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = rel_err(got.float(), want.float())
    log(f"  {name}: rel_err {err:.3e} (limit {limit:g})")
    if not err <= limit:
        raise AssertionError(f"{name}: rel_err {err} > limit {limit}")
    return err


def reset_counters():
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def phase_build():
    def timed_build(name):
        t0 = time.perf_counter()
        kernels.build(name)
        return time.perf_counter() - t0

    names = [os.path.splitext(src)[0] for src in SOURCES.values()]
    with ThreadPoolExecutor(len(names)) as ex:
        seconds = dict(zip(names, ex.map(timed_build, names)))
    for name in names:
        kernels.load(name)
        info = kernels.library_path(name).with_suffix(".log")
        log(f"build {name}: {seconds[name]:.2f} s (nvcc sm_90a, in parallel, "
            f"{kernels.library_path(name).name})")
        if info.exists():
            for line in info.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")


def _gru_inputs(g, b, l, d, h):
    k = 1.0 / h ** 0.5
    u = lambda *s: torch.empty(*s).uniform_(-k, k, generator=g)  # noqa: E731
    w = [u(3 * h, d), u(3 * h, h), u(3 * h), u(3 * h)]
    x = torch.randn(b, l, d, generator=g) * 0.1
    lengths = torch.randint(1, l + 1, (b,), generator=g)
    lengths[0], lengths[1] = 1, l
    mask = (torch.arange(l)[None] < lengths[:, None]).float()
    return [t.to(DEV) for t in [x, mask] + w]


def phase_gru(g) -> dict:
    log("GRU kernel vs plain gru_scan (B=128, L=24, D=300, H=1024, ragged lengths 1..24)")
    x, mask, w_ih, w_hh, b_ih, b_hh = _gru_inputs(g, 128, 24, 300, 1024)
    w_hh16 = w_hh.to(torch.bfloat16)
    res = {}
    for reverse in (False, True):
        tag = "reverse" if reverse else "forward"
        for mode, w_k, dot, atol in (("fp32", w_hh, torch.float32, GRU_FP32_ATOL),
                                     ("bf16", w_hh16, torch.bfloat16, GRU_BF16_ATOL)):
            got = gru_scan_fused(x, mask, w_ih, w_k, b_ih, b_hh, reverse=reverse)
            want = gru_scan(x, mask, w_ih, w_k, b_ih, b_hh, reverse=reverse,
                            dot_dtype=dot)
            e_o = check(f"gru {tag} {mode} W_hh outputs", got[0], want[0], atol)
            e_h = check(f"gru {tag} {mode} W_hh final", got[1], want[1], atol)
            if mode == "bf16" and not reverse:
                res["max_abs_err"] = max(e_o, e_h)
    # main-path mode: encode_bf16 gives bf16 x and weights
    xb, wib, whb, bib, bhb = (t.to(torch.bfloat16) for t in (x, w_ih, w_hh, b_ih, b_hh))
    res["ms"] = cuda_ms(lambda: gru_scan_fused(xb, mask, wib, whb, bib, bhb))
    res["plain_ms"] = cuda_ms(lambda: gru_scan(xb, mask, wib, whb, bib, bhb,
                                               dot_dtype=torch.bfloat16))
    res["ms_fp32"] = cuda_ms(lambda: gru_scan_fused(x, mask, w_ih, w_hh, b_ih, b_hh))
    res["plain_ms_fp32"] = cuda_ms(lambda: gru_scan(x, mask, w_ih, w_hh, b_ih, b_hh))
    # the library yardstick: cuDNN's GRU on the same padded batch (it runs
    # every step of every row; the masked kernel freezes the carry past each
    # length), input projection included as in the kernel's call
    with torch.no_grad():
        lib16 = cudnn_gru(w_ih, w_hh, b_ih, b_hh, torch.bfloat16)
        lib32 = cudnn_gru(w_ih, w_hh, b_ih, b_hh, torch.float32)
        res["library_ms"] = cuda_ms(lambda: lib16(xb))
        res["library_ms_fp32"] = cuda_ms(lambda: lib32(x))
    res["library_call"] = "torch.nn.GRU (cuDNN) forward, same padded batch and dtype"
    b, l, d = x.shape
    h = w_hh.shape[1]
    n_valid = float(mask.sum())
    # inputs and weights read once, outputs and final state written once (in
    # x's dtype), over the valid steps only: the input projection and the
    # recurrent product (2 n_valid (D + H) 3H).  In bf16 mode both products
    # take bf16 operands (the kernel rounds the carry to bf16), so both count
    # at the bf16 tensor-core peak; in fp32 mode at the fp32 peak.
    ops = 2 * n_valid * (d + h) * 3 * h
    res.update(bound(nbytes(xb, mask, wib, whb, bib, bhb) + 2 * (b * l * h + b * h),
                     {"bf16": ops}))
    b32 = bound(nbytes(x, mask, w_ih, w_hh, b_ih, b_hh) + 4 * (b * l * h + b * h),
                {"fp32": ops})
    res["bound_ms_fp32"], res["bound_by_fp32"] = b32["bound_ms"], b32["bound_by"]
    log(f"  time bf16 (B=128, L=24, H=1024, one direction): kernel {res['ms']:.3f} ms, "
        f"plain {res['plain_ms']:.3f} ms, cuDNN {res['library_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}); fp32: kernel "
        f"{res['ms_fp32']:.3f} ms, plain {res['plain_ms_fp32']:.3f} ms, cuDNN (TF32 off) "
        f"{res['library_ms_fp32']:.3f} ms, bound {res['bound_ms_fp32']:.4f} ms "
        f"({res['bound_by_fp32']})")
    return res


def phase_gru_bwd(g, b=128, l=48, d=300, h=1024, timed: bool = True) -> dict:
    """The GRU adjoint kernel (and the forward's residual mode) against the
    plain versions, at the training path's widths: B=128, L=48 (the caption
    length of scripts/train_bench.py), D=300, H=1024, fp32, ragged lengths
    1..48, both directions; with `timed`, then the times and the bound."""
    log(f"GRU adjoint kernel vs plain (B={b}, L={l}, D={d}, H={h}, fp32, ragged 1..{l})")
    x, mask, w_ih, w_hh, b_ih, b_hh = _gru_inputs(g, b, l, d, h)
    g_out = torch.randn(b, l, h, generator=g).to(DEV)
    g_fin = torch.randn(b, h, generator=g).to(DEV)
    names = ("dx", "dW_ih", "dW_hh", "db_ih", "db_hh")

    def grads(fn, reverse, cot_out):
        ps = [t.detach().clone().requires_grad_() for t in (x, w_ih, w_hh, b_ih, b_hh)]
        o, fin = fn(ps[0], mask, *ps[1:], reverse=reverse)
        return torch.autograd.grad((o * cot_out).sum() + (fin * g_fin).sum(), ps)

    res = {"rel_err": {}}
    dropped = g_out.clone()
    dropped[:, l // 2] = 0.0
    for reverse in (False, True):
        tag = "reverse" if reverse else "forward"
        got = grads(gru_scan_fused, reverse, g_out)
        want = grads(gru_scan, reverse, g_out)
        lost = grads(gru_scan, reverse, dropped)
        for name, a, w, c in zip(names, got, want, lost):
            err = check_rel(f"gru {tag} {name} (kernel fwd+bwd vs autograd of plain)",
                            a, w, GRU_BWD_REL)
            wrong = rel_err(c, w)
            log(f"    the plain {name} with timestep {l // 2}'s cotangent dropped: "
                f"rel_err {wrong:.3e}")
            if not wrong > GRU_BWD_REL:
                raise AssertionError(f"the limit {GRU_BWD_REL} does not separate a lost "
                                     f"timestep ({wrong}) in {name}")
            res["rel_err"][f"{tag} {name}"] = err

        # the two kernel bodies on the same residuals
        gates_x = (x @ w_ih.t() + b_ih).contiguous()
        k_out, k_fin, hall, ghall = kgru._launch(gates_x, mask, w_hh, b_hh, reverse,
                                                 residuals=True)
        p_out, p_fin, p_hall, p_ghall = gru_fwd_plain(gates_x, mask, w_hh, b_hh, reverse)
        check(f"gru {tag} residual hall (h_t-1)", hall, p_hall, GRU_FP32_ATOL)
        check(f"gru {tag} residual ghall (gh)", ghall, p_ghall, GRU_FP32_ATOL)
        check(f"gru {tag} outputs with residuals", k_out, p_out, GRU_FP32_ATOL)
        kb = gru_bwd_fused(gates_x, mask, hall, ghall, g_out, g_fin, w_hh, reverse)
        pb = gru_bwd_plain(gates_x, mask, hall, ghall, g_out, g_fin, w_hh, reverse)
        for name, a, w in zip(("ggx", "ghn", "g_h0"), kb, pb):
            err = check_rel(f"gru_bwd {tag} {name} (kernel vs gru_bwd_plain)", a, w,
                            GRU_BWD_REL)
            res["rel_err"][f"{tag} {name}"] = err
            if name == "ggx" and not reverse:
                res["max_abs_err"] = float((a - w).abs().max())
        # both cotangents absent: zero gradients
        z = gru_bwd_fused(gates_x, mask, hall, ghall, None, None, w_hh, reverse)
        if any(float(t.abs().max()) != 0.0 for t in z):
            raise AssertionError("gru_bwd with no cotangent gave non-zero gradients")
    if not timed:
        return res

    gates_x = (x @ w_ih.t() + b_ih).contiguous()
    _, _, hall, ghall = kgru._launch(gates_x, mask, w_hh, b_hh, False, residuals=True)
    res["ms"] = cuda_ms(lambda: gru_bwd_fused(gates_x, mask, hall, ghall, g_out, g_fin, w_hh))
    res["plain_ms"] = cuda_ms(
        lambda: gru_bwd_plain(gates_x, mask, hall, ghall, g_out, g_fin, w_hh))
    res["fwd_residuals_ms"] = cuda_ms(
        lambda: kgru._launch(gates_x, mask, w_hh, b_hh, False, residuals=True))
    res["fwd_ms"] = cuda_ms(
        lambda: kgru._launch(gates_x, mask, w_hh, b_hh, False, residuals=False))
    res["fwd_plain_ms"] = cuda_ms(lambda: gru_fwd_plain(gates_x, mask, w_hh, b_hh))
    res["fwd_bwd_ms"] = cuda_ms(lambda: grads(gru_scan_fused, False, g_out), reps=10)
    res["fwd_bwd_plain_ms"] = cuda_ms(lambda: grads(gru_scan, False, g_out), reps=10)
    # the library yardstick: cuDNN's GRU forward + backward under autograd on
    # the same padded batch (fp32, TF32 off); no single call computes the
    # adjoint alone, so it stands beside the kernels' forward + backward
    lib = cudnn_gru(w_ih, w_hh, b_ih, b_hh, torch.float32)
    xg = x.detach().clone().requires_grad_()

    def lib_fwd_bwd():
        o, fin = lib(xg)
        return torch.autograd.grad((o * g_out).sum() + (fin[0] * g_fin).sum(),
                                   [xg, *lib.parameters()])

    res["library_ms"] = cuda_ms(lib_fwd_bwd, reps=10)
    res["library_call"] = ("torch.nn.GRU (cuDNN) forward + backward under autograd, "
                           "beside the kernels' forward + backward (fwd_bwd_ms)")
    n_valid = float(mask.sum())
    # the adjoint alone: gates_x, mask, the residuals, both cotangents and W_hh
    # read once, the gate gradients and the initial state's written once;
    # (B, 3H) x (3H, H) by fp32 FMAs per valid step
    res.update(bound(
        nbytes(gates_x, mask, hall, ghall, g_out, g_fin, w_hh) + 4 * (
            gates_x.numel() + hall.numel() + b * h),
        {"fp32": 2 * n_valid * 3 * h * h}))
    log(f"  time (one direction, B={b}, L={l}, H={h}, fp32): adjoint kernel "
        f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms; forward kernel with "
        f"residuals {res['fwd_residuals_ms']:.3f} ms, without {res['fwd_ms']:.3f} ms, "
        f"plain {res['fwd_plain_ms']:.3f} ms; forward+backward through autograd "
        f"(input projection included): kernels {res['fwd_bwd_ms']:.3f} ms, plain "
        f"{res['fwd_bwd_plain_ms']:.3f} ms, cuDNN {res['library_ms']:.3f} ms; adjoint "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def _xattn_inputs(g, ni, nc, l, d=1024, single_word=True):
    img = torch.randn(ni, 36, d, generator=g)
    img = img / img.norm(dim=-1, keepdim=True)
    lengths = torch.randint(2, l + 1, (nc,), generator=g)
    if single_word:
        lengths[0] = 1
    mask = (torch.arange(l)[None] < lengths[:, None]).float()
    cap = torch.tanh(torch.randn(nc, l, d, generator=g) * 0.5) * mask[..., None]
    return img.to(DEV), cap.to(DEV), mask.to(DEV)


def xattn_bound(img, cap, mask, direction: str) -> dict:
    """The bound of one score grid: images, captions and mask read once, the
    fp32 grid written once; the A product over the valid words (bf16 tensor
    cores for bf16 inputs) and the chain after it by fp32 FMAs (t2i: the
    36 x 36 region Gram per word; i2t: the L x L word Gram per region, plus
    some ten operations per (region, word) either way)."""
    ni, r, d = img.shape
    lengths = mask.sum(dim=1).double()
    a_ops = 2.0 * ni * r * d * float(lengths.sum())
    if direction == "t2i":
        chain = ni * float(lengths.sum()) * (2 * r * r + 10 * r)
    else:
        chain = ni * r * float((2 * lengths ** 2 + 10 * lengths).sum())
    if img.dtype == torch.bfloat16:
        ops = {"bf16": a_ops, "fp32": chain}
    else:
        ops = {"fp32": a_ops + chain}
    return bound(nbytes(img, cap, mask) + 4 * ni * cap.shape[0], ops)


def phase_xattn(g) -> dict:
    log("xattn t2i kernel vs plain (clipped_l2norm; R=36, D=1024)")
    res = {}
    for ni, nc, l in ((64, 320, 24), (37, 211, 24)):
        img, cap, mask = _xattn_inputs(g, ni, nc, l)
        for agg in ("LogSumExp", "Mean"):
            img16, cap16 = img.to(torch.bfloat16), cap.to(torch.bfloat16)
            got = xattn_t2i_fused(img16, cap16, mask, agg_func=agg)
            want = xattn_t2i_plain(img16.float(), cap16.float(), mask, agg_func=agg)
            e16 = check(f"xattn {ni}x{nc}x36x{l} {agg} bf16", got, want, XATTN_BF16_ATOL)
            got = xattn_t2i_fused(img, cap, mask, agg_func=agg)
            want = xattn_t2i_plain(img, cap, mask, agg_func=agg)
            check(f"xattn {ni}x{nc}x36x{l} {agg} fp32", got, want, XATTN_FP32_ATOL)
            if (ni, agg) == (64, "LogSumExp"):
                res["max_abs_err"] = e16
    img, cap, mask = _xattn_inputs(g, 64, 320, 24)
    img16, cap16 = img.to(torch.bfloat16), cap.to(torch.bfloat16)
    res["ms"] = cuda_ms(lambda: xattn_t2i_fused(img16, cap16, mask))
    res["plain_ms"] = cuda_ms(lambda: xattn_t2i_plain(img16, cap16, mask))
    res["ms_fp32"] = cuda_ms(lambda: xattn_t2i_fused(img, cap, mask))
    res["plain_ms_fp32"] = cuda_ms(lambda: xattn_t2i_plain(img, cap, mask))
    res.update(xattn_bound(img16, cap16, mask, "t2i"))
    # no single PyTorch call computes the stacked cross-attention score grid
    res["library_ms"] = None
    log(f"  time 64x320x36x24x1024 LSE bf16: kernel {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
        f"fp32: kernel {res['ms_fp32']:.3f} ms, plain {res['plain_ms_fp32']:.3f} ms")
    return res


def phase_xattn_i2t(g) -> dict:
    log(f"xattn i2t kernel vs plain (clipped_l2norm; R=36, D=1024, lambda_softmax "
        f"{I2T_SOFTMAX:g}, LogSumExp at lambda_lse {I2T_LSE:g})")
    res = {}
    kw = {"LogSumExp": dict(agg_func="LogSumExp", lambda_lse=I2T_LSE,
                            lambda_softmax=I2T_SOFTMAX),
          "Mean": dict(agg_func="Mean", lambda_softmax=I2T_SOFTMAX)}
    for ni, nc, l in ((64, 320, 24), (37, 211, 24)):
        img, cap, mask = _xattn_inputs(g, ni, nc, l)
        img16, cap16 = img.to(torch.bfloat16), cap.to(torch.bfloat16)
        for agg, k in kw.items():
            got = xattn_i2t_fused(img16, cap16, mask, **k)
            want = xattn_i2t_plain(img16.float(), cap16.float(), mask, **k)
            e16 = check(f"xattn_i2t {ni}x{nc}x36x{l} {agg} bf16", got, want, XATTN_BF16_ATOL)
            got = xattn_i2t_fused(img, cap, mask, **k)
            want = xattn_i2t_plain(img, cap, mask, **k)
            check(f"xattn_i2t {ni}x{nc}x36x{l} {agg} fp32", got, want, XATTN_FP32_ATOL)
            if (ni, agg) == (64, "Mean"):
                res["max_abs_err"] = e16
    # a caption as long as the kernel takes (one caption per block, its
    # 64 KB Gram in shared memory)
    img, cap, mask = _xattn_inputs(g, 5, 7, 128)
    check("xattn_i2t 5x7x36x128 Mean bf16", xattn_i2t_fused(
        img.to(torch.bfloat16), cap.to(torch.bfloat16), mask, **kw["Mean"]),
        xattn_i2t_plain(img.to(torch.bfloat16).float(), cap.to(torch.bfloat16).float(),
                        mask, **kw["Mean"]), XATTN_BF16_ATOL)
    # the main path's mode: i-t AVG, bf16
    img, cap, mask = _xattn_inputs(g, 64, 320, 24)
    img16, cap16 = img.to(torch.bfloat16), cap.to(torch.bfloat16)
    res["ms"] = cuda_ms(lambda: xattn_i2t_fused(img16, cap16, mask, **kw["Mean"]))
    res["plain_ms"] = cuda_ms(lambda: xattn_i2t_plain(img16, cap16, mask, **kw["Mean"]))
    res["ms_fp32"] = cuda_ms(lambda: xattn_i2t_fused(img, cap, mask, **kw["Mean"]))
    res["plain_ms_fp32"] = cuda_ms(lambda: xattn_i2t_plain(img, cap, mask, **kw["Mean"]))
    res["ms_t2i_same_inputs"] = cuda_ms(lambda: xattn_t2i_fused(img16, cap16, mask))
    res.update(xattn_bound(img16, cap16, mask, "i2t"))
    # no single PyTorch call computes the stacked cross-attention score grid
    res["library_ms"] = None
    log(f"  time 64x320x36x24x1024 Mean bf16: kernel {res['ms']:.3f} ms (the t2i kernel "
        f"on the same inputs {res['ms_t2i_same_inputs']:.3f} ms), plain "
        f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
        f"fp32: kernel {res['ms_fp32']:.3f} ms, plain {res['plain_ms_fp32']:.3f} ms")
    return res


def _saf_inputs(g, ni, nc, l, d=1024, s=256):
    """Embeddings as _xattn_inputs gives them, unit global embeddings, and
    SGRAF-SAF weights at the reference's init scale (xavier U(-r, r)), with
    small random biases and a folded gate."""
    img, cap, mask = _xattn_inputs(g, ni, nc, l, d)
    u = lambda r, *sh: (torch.rand(*sh, generator=g) * 2 - 1) * r  # noqa: E731
    unit = lambda n: torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=-1)  # noqa: E731
    r_loc = math.sqrt(6.0 / (d + s))
    w = {"w": u(r_loc, s, d), "b": u(0.05, s), "gloc": unit(nc), "imgglo": unit(ni),
         "gw": u(r_loc, s, d), "gb": u(0.05, s), "awf": u(math.sqrt(6.0 / (s + 1)), s),
         "abf": u(0.5, 1), "ew": u(math.sqrt(6.0 / (s + 1)), 1, s), "eb": u(0.1, 1)}
    return dict(cap=cap, mask=mask, img=img, **{k: v.to(DEV) for k, v in w.items()})


def _saf_cast(x: dict, dtype) -> dict:
    """The embeddings in `dtype` (the weights stay fp32, as the model keeps
    them)."""
    return {k: v.to(dtype) if k in ("cap", "img", "gloc", "imgglo") else v for k, v in x.items()}


def saf_bound(img, cap, mask, s: int = 256) -> dict:
    """The bound of one SAF score grid: the embeddings (the global ones in
    their dtype too), the mask and the fp32 weights read once, the fp32 grid
    written once; the A, context and projection products over the valid
    words and the global node per pair (at the bf16 tensor-core peak for bf16
    embeddings, else at the fp32 peak), and the rest of the chain by fp32
    operations: per valid word the 36 x 36 Gram form, the region softmax,
    the squared difference (3 D) and the node's norm, gate and pooling (6 S);
    per pair the global difference (3 D) and the same node work."""
    ni, r, d = img.shape
    nc = cap.shape[0]
    n_words = float(mask.sum())
    products = 2.0 * ni * n_words * (2 * r * d + d * s) + 2.0 * ni * nc * d * s
    rest = ni * n_words * (2 * r * r + 10 * r + 3 * d + 6 * s) + ni * nc * (3 * d + 6 * s)
    if img.dtype == torch.bfloat16:
        ops = {"bf16": products, "fp32": rest}
    else:
        ops = {"fp32": products + rest}
    n_bytes = nbytes(img, cap, mask) + (ni + nc) * d * img.element_size() \
        + 4 * (2 * s * d + 4 * s + 2) + 4 * ni * nc
    return bound(n_bytes, ops)


def phase_sgraf_eval_saf(g) -> dict:
    log("sgraf_eval_saf kernel vs plain (R=36, D=1024, S=256, lambda 9)")
    res = {}
    # the main width, then a ragged shape: a single-word caption, L not a
    # multiple of 8, an odd caption count and an odd image count
    for ni, nc, l in ((64, 320, 24), (37, 211, 21)):
        x = _saf_inputs(g, ni, nc, l)
        x16 = _saf_cast(x, torch.bfloat16)
        got = sgraf_eval_saf_fused(**x16)
        want = sgraf_eval_saf_plain(**_saf_cast(x16, torch.float32))
        e16 = check(f"sgraf_eval_saf {ni}x{nc}x36x{l} bf16", got, want, SAF_BF16_ATOL)
        check(f"sgraf_eval_saf {ni}x{nc}x36x{l} fp32", sgraf_eval_saf_fused(**x),
              sgraf_eval_saf_plain(**x), SAF_FP32_ATOL)
        if ni == 64:
            res["max_abs_err"] = e16
            spread = float(want.std(dim=1).mean())
            log(f"  mean per-caption std of the scores over images: {spread:.3e}")
    x = _saf_inputs(g, 64, 320, 24)
    x16 = _saf_cast(x, torch.bfloat16)
    res["ms"] = cuda_ms(lambda: sgraf_eval_saf_fused(**x16), reps=10)
    res["plain_ms"] = cuda_ms(lambda: sgraf_eval_saf_plain(**x16), reps=10)
    res["ms_fp32"] = cuda_ms(lambda: sgraf_eval_saf_fused(**x), reps=10)
    res["plain_ms_fp32"] = cuda_ms(lambda: sgraf_eval_saf_plain(**x), reps=10)
    res.update(saf_bound(x16["img"], x16["cap"], x16["mask"]))
    b32 = saf_bound(x["img"], x["cap"], x["mask"])
    res["bound_ms_fp32"], res["bound_by_fp32"] = b32["bound_ms"], b32["bound_by"]
    # no single PyTorch call computes the SGRAF-SAF score grid
    res["library_ms"] = None
    log(f"  time 64x320x36x24x1024, S 256, bf16: kernel {res['ms']:.3f} ms (PR 6: "
        f"{SAF_PR6_MS[0]:.3f}), plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}); fp32: kernel {res['ms_fp32']:.3f} ms (PR 6: {SAF_PR6_MS[1]:.3f}), "
        f"plain {res['plain_ms_fp32']:.3f} ms, bound {res['bound_ms_fp32']:.4f} ms "
        f"({res['bound_by_fp32']})")
    return res


def _sgr_inputs(g, ni, nc, l, steps, d=1024, s=256):
    """The SAF phase's embeddings and node weights, and `steps` GraphReasoning
    steps at the reference's init scale (xavier U(-r, r) over S x S) with
    small random biases (the JAX package's are zero at init; random ones
    exercise the fold's key-side term)."""
    x = _saf_inputs(g, ni, nc, l, d, s)
    del x["awf"], x["abf"]
    ew, eb = x.pop("ew"), x.pop("eb")
    u = lambda r, *sh: ((torch.rand(*sh, generator=g) * 2 - 1) * r).to(DEV)  # noqa: E731
    r = math.sqrt(6.0 / (2 * s))
    for k in ("q", "k", "g"):
        x[f"w{k}"], x[f"b{k}"] = u(r, steps, s, s), u(0.05, steps, s)
    x["ew"], x["eb"] = ew, eb
    return x


SGR_STEP_WEIGHTS = ("wq", "bq", "wk", "bk", "wg", "bg")


def sgr_bound(img, cap, mask, s: int = 256, steps: int = 3) -> dict:
    """The bound of one SGR score grid: saf_bound's inputs plus the steps'
    Linears read once, the fp32 grid written once; the A, context and
    projection products over the valid words and the global node per pair
    (saf_bound's), and per pair over its n = valid words + 1 nodes the
    reasoning, (steps - 1) (4 n S^2 + 4 n^2 S) + 4 S^2 + 4 n S (the q/k
    fold's S M and ctx W_g per node and full step, the edges and contexts,
    then the node-0 step), all at the bf16 tensor-core peak for bf16
    embeddings, else at the fp32 peak; the rest of the chain by fp32
    operations: per valid word the 36 x 36 Gram form, the region softmax,
    the squared difference (3 D) and the node's bias and norm (3 S), per pair
    the global difference (3 D) and its node's (3 S)."""
    ni, r, d = img.shape
    nc = cap.shape[0]
    words = mask.sum(dim=1).double()
    n_words = float(words.sum())
    n = words + 1
    align = 2.0 * ni * n_words * (2 * r * d + d * s) + 2.0 * ni * nc * d * s
    reason = ni * float(((steps - 1) * (4 * n * s * s + 4 * n * n * s)
                         + 4 * s * s + 4 * n * s).sum())
    rest = ni * n_words * (2 * r * r + 10 * r + 3 * d + 3 * s) + ni * nc * (3 * d + 3 * s)
    if img.dtype == torch.bfloat16:
        ops = {"bf16": align + reason, "fp32": rest}
    else:
        ops = {"fp32": align + reason + rest}
    n_bytes = nbytes(img, cap, mask) + (ni + nc) * d * img.element_size() \
        + 4 * (2 * s * d + 2 * s + steps * (3 * s * s + 3 * s) + s + 1) + 4 * ni * nc
    return bound(n_bytes, ops)


def phase_sgraf_eval_sgr(g) -> dict:
    log("sgraf_eval_sgr kernel vs plain (R=36, D=1024, S=256, lambda 9, q/k fold)")
    res = {}
    # the main width at sgr_step 3, then a ragged shape: a single-word
    # caption, L not a multiple of 8, odd counts and sgr_step 1 (node 0 alone)
    for ni, nc, l, steps in ((64, 320, 24, 3), (37, 211, 21, 1)):
        x = _sgr_inputs(g, ni, nc, l, steps)
        x16 = _saf_cast(x, torch.bfloat16)
        got = sgraf_eval_sgr_fused(**x16)
        want = sgraf_eval_sgr_plain(**_saf_cast(x16, torch.float32))
        tag = f"sgraf_eval_sgr {ni}x{nc}x36x{l} steps {steps}"
        e16 = check(f"{tag} bf16", got, want, SGR_BF16_ATOL)
        check(f"{tag} fp32", sgraf_eval_sgr_fused(**x), sgraf_eval_sgr_plain(**x),
              SGR_FP32_ATOL)
        spread = float(want.std(dim=1).mean())
        log(f"  {tag}: mean per-caption std of the scores over images {spread:.3e} "
            f"(limits {SGR_BF16_ATOL:g} bf16, {SGR_FP32_ATOL:g} fp32)")
        if ni == 64:
            res["max_abs_err"] = e16
    # a caption as long as the kernel takes (one caption per block, 129 nodes
    # a pair, near the edge staging buffer's 134 rows), and sim_dim 128
    for ni, nc, l, steps, s in ((5, 7, 128, 2, 256), (9, 13, 16, 2, 128)):
        x16 = _saf_cast(_sgr_inputs(g, ni, nc, l, steps, s=s), torch.bfloat16)
        check(f"sgraf_eval_sgr {ni}x{nc}x36x{l} steps {steps} S {s} bf16",
              sgraf_eval_sgr_fused(**x16), sgraf_eval_sgr_plain(**_saf_cast(x16, torch.float32)),
              SGR_BF16_ATOL)
    x = _sgr_inputs(g, 64, 320, 24, 3)
    x16 = _saf_cast(x, torch.bfloat16)
    res["ms"] = cuda_ms(lambda: sgraf_eval_sgr_fused(**x16), reps=10)
    res["plain_ms"] = cuda_ms(lambda: sgraf_eval_sgr_plain(**x16), reps=10)
    res["ms_fp32"] = cuda_ms(lambda: sgraf_eval_sgr_fused(**x), reps=10)
    res["plain_ms_fp32"] = cuda_ms(lambda: sgraf_eval_sgr_plain(**x), reps=10)
    # where the kernel's time goes: the same inputs at 1 and 2 steps (the
    # node-0 step alone, then one full step more)
    res["ms_by_steps"] = {
        k: cuda_ms(lambda k=k: sgraf_eval_sgr_fused(
            **{n: v[-k:] if n in SGR_STEP_WEIGHTS else v for n, v in x16.items()}),
            reps=10)
        for k in (1, 2)}
    res["ms_by_steps"][3] = res["ms"]
    res.update(sgr_bound(x16["img"], x16["cap"], x16["mask"]))
    b32 = sgr_bound(x["img"], x["cap"], x["mask"])
    res["bound_ms_fp32"], res["bound_by_fp32"] = b32["bound_ms"], b32["bound_by"]
    # no single PyTorch call computes the SGRAF-SGR score grid
    res["library_ms"] = None
    log(f"  time 64x320x36x24x1024, S 256, sgr_step 3, bf16: kernel {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); fp32: "
        f"kernel {res['ms_fp32']:.3f} ms, plain {res['plain_ms_fp32']:.3f} ms, bound "
        f"{res['bound_ms_fp32']:.4f} ms ({res['bound_by_fp32']})")
    log("  kernel bf16 by sgr_step (1: the node-0 step alone): " + ", ".join(
        f"{k}: {v:.3f} ms" for k, v in res["ms_by_steps"].items()))
    return res


def _align_inputs(g, ni, nc, l, d=1024, s=256):
    """The SAF phase's embeddings, sim_tranloc_w at the reference's init
    scale with a small random bias, and a cotangent that is zero at masked
    words (SAF's)."""
    img, cap, mask = _xattn_inputs(g, ni, nc, l, d)
    r = math.sqrt(6.0 / (d + s))
    w = ((torch.rand(s, d, generator=g) * 2 - 1) * r).to(DEV)
    b = ((torch.rand(s, generator=g) * 2 - 1) * 0.05).to(DEV)
    cot = torch.randn(nc, ni, l, s, generator=g).to(DEV) * mask[:, None, :, None]
    return dict(cap=cap, mask=mask, img=img, w=w, b=b), cot


def align_bound(img, cap, mask, s: int = 256, backward: bool = False) -> dict:
    """The bound of one alignment call.  Forward: cap, img, mask and the fp32
    W, b read once, the (Nc, Ni, L, S) nodes written once in cap's dtype; per
    valid word and image the A and context products (36 x D each) and the
    projection (D x S), at the bf16 tensor-core peak for bf16 embeddings
    (else fp32), and some 4 D + 50 R + 4 S fp32 operations of the chain.
    Backward: the same inputs and the cotangent read once, gcap and gimg (in
    cap's dtype) and the fp32 dW, db written once; the recomputed products,
    W gy and dW (D x S each) and four more 36 x D products, and about twice
    the forward's chain."""
    ni, r, d = img.shape
    nc, l, _ = cap.shape
    pairs = ni * float(mask.sum())
    es = img.element_size()
    if backward:
        products = 2.0 * pairs * (6 * r * d + 3 * d * s)
        rest = 2.0 * pairs * (4 * d + 50 * r + 4 * s)
        n_bytes = nbytes(img, cap, mask) + 4 * (s * d + s) + nc * ni * l * s * es \
            + (cap.numel() + img.numel()) * es + 4 * (s * d + s)
    else:
        products = 2.0 * pairs * (2 * r * d + d * s)
        rest = pairs * (4 * d + 50 * r + 4 * s)
        n_bytes = nbytes(img, cap, mask) + 4 * (s * d + s) + nc * ni * l * s * es
    ops = {"bf16": products, "fp32": rest} if img.dtype == torch.bfloat16 \
        else {"fp32": products + rest}
    return bound(n_bytes, ops)


def phase_sgraf_align(g) -> dict:
    """The training alignment kernels vs their plain pair: one training chunk
    at full width (32 captions x 128 images x 36 x 24 x 1024, S 256, ragged
    lengths 1-24), then a ragged odd shape; bf16 and fp32."""
    log("sgraf_align forward + backward kernels vs plain (R=36, D=1024, S=256, lambda 9)")
    res = {}
    names = ("gcap", "gimg", "gw", "gb")
    for nc, ni, l in ALIGN_SHAPES:
        x, cot = _align_inputs(g, ni, nc, l)
        for dt in (torch.bfloat16, torch.float32):
            tag = f"sgraf_align {nc}x{ni}x36x{l} {'bf16' if dt == torch.bfloat16 else 'fp32'}"
            xd = dict(x, cap=x["cap"].to(dt), img=x["img"].to(dt))
            with torch.no_grad():
                got = sgraf_align_fused(**xd)
            want = sgraf_align_plain(**xd)
            e_fwd = check(f"{tag} forward", got, want,
                          ALIGN_BF16_ATOL if dt == torch.bfloat16 else ALIGN_FP32_ATOL)
            kb = sgraf_align_bwd_fused(**xd, g=cot.to(dt))
            pb = sgraf_align_bwd_plain(**xd, g=cot.to(dt))
            # the fault the limit must separate: one caption's cotangent lost
            lost = cot.clone()
            lost[nc // 2] = 0.0
            lb = sgraf_align_bwd_plain(**xd, g=lost.to(dt))
            errs = {}
            for name, a, w_, c_ in zip(names, kb, pb, lb):
                lim = ALIGN_BWD_BF16_REL if a.dtype == torch.bfloat16 else ALIGN_BWD_REL
                errs[name] = check_rel(f"{tag} backward {name}", a, w_, lim)
                wrong = rel_err(c_.float(), w_.float())
                log(f"    the plain {name} with caption {nc // 2}'s cotangent dropped: "
                    f"rel_err {wrong:.3e}")
                if not wrong > lim:
                    raise AssertionError(f"the limit {lim} does not separate a lost "
                                         f"caption ({wrong}) in {name}")
            again = sgraf_align_bwd_fused(**xd, g=cot.to(dt))
            same = all(torch.equal(a, b_) for a, b_ in zip(kb, again))
            log(f"  {tag}: two backward calls bit-identical: {same}")
            if not same:
                raise AssertionError(f"{tag}: the backward is not deterministic")
            if (nc, ni, l) == ALIGN_SHAPES[0] and dt == torch.bfloat16:
                res["max_abs_err"] = e_fwd
                res["bwd_max_abs_err"] = max(float((a.float() - w_.float()).abs().max())
                                             for a, w_ in zip(kb, pb))
                res["bwd_rel_err"] = errs
                res["bwd_deterministic"] = same
    nc, ni, l = ALIGN_SHAPES[0]
    x, cot = _align_inputs(g, ni, nc, l)
    for dt, suf in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        xd = dict(x, cap=x["cap"].to(dt), img=x["img"].to(dt))
        c_ = cot.to(dt)
        with torch.no_grad():
            res["ms" + suf] = cuda_ms(lambda: sgraf_align_fused(**xd), reps=10)
            res["plain_ms" + suf] = cuda_ms(lambda: sgraf_align_plain(**xd), reps=5)
        res["bwd_ms" + suf] = cuda_ms(lambda: sgraf_align_bwd_fused(**xd, g=c_), reps=10)
        res["bwd_plain_ms" + suf] = cuda_ms(lambda: sgraf_align_bwd_plain(**xd, g=c_), reps=5)
        fb = align_bound(xd["img"], xd["cap"], xd["mask"])
        bb = align_bound(xd["img"], xd["cap"], xd["mask"], backward=True)
        res["bound_ms" + suf], res["bound_by" + suf] = fb["bound_ms"], fb["bound_by"]
        res["bwd_bound_ms" + suf], res["bwd_bound_by" + suf] = bb["bound_ms"], bb["bound_by"]
    # no single PyTorch call computes the alignment chain or its backward
    res["library_ms"] = None
    log(f"  time 32x128x36x24x1024, S 256, bf16: forward kernel {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
        f"backward kernels {res['bwd_ms']:.3f} ms, plain {res['bwd_plain_ms']:.3f} ms, bound "
        f"{res['bwd_bound_ms']:.4f} ms ({res['bwd_bound_by']}); fp32: forward "
        f"{res['ms_fp32']:.3f} ms (plain {res['plain_ms_fp32']:.3f}, bound "
        f"{res['bound_ms_fp32']:.4f}), backward {res['bwd_ms_fp32']:.3f} ms (plain "
        f"{res['bwd_plain_ms_fp32']:.3f}, bound {res['bwd_bound_ms_fp32']:.4f})")
    return res


def align_bwd_result(res: dict) -> dict:
    """The backward kernels' row of the kernels line, from the phase's
    result."""
    return {"max_abs_err": res["bwd_max_abs_err"], "ms": res["bwd_ms"],
            "plain_ms": res["bwd_plain_ms"], "bound_ms": res["bwd_bound_ms"],
            "bound_by": res["bwd_bound_by"], "library_ms": None}


def _sgr_reason_inputs(g, pairs, l, steps, s):
    """Nodes as the training tower gives them: per pair a global node and
    one node per valid word of a ragged caption (lengths 1..l, one caption
    of one word and one of l), unit rows, zero at masked words; the steps'
    Linears at the reference's init scale with small random biases; a
    cotangent that is random at every valid node and zero elsewhere."""
    lengths = torch.randint(1, l + 1, (pairs,), generator=g)
    lengths[0], lengths[-1] = 1, l
    mask = torch.cat([torch.ones(pairs, 1), (torch.arange(l)[None] < lengths[:, None]).float()],
                     dim=1)
    s0 = torch.randn(pairs, l + 1, s, generator=g)
    s0 = s0 / s0.norm(dim=-1, keepdim=True) * mask[..., None]
    r = math.sqrt(6.0 / (2 * s))
    u = lambda a, *sh: (torch.rand(*sh, generator=g) * 2 - 1) * a  # noqa: E731
    w = {}
    for k in ("q", "k", "g"):
        w[f"w{k}"], w[f"b{k}"] = u(r, steps, s, s), u(0.05, steps, s)
    cot = torch.randn(pairs, l + 1, s, generator=g) * mask[..., None]
    x = dict(s0=s0, mask=mask, **{k: w[k] for k in SGR_STEP_WEIGHTS})
    return {k: v.to(DEV) for k, v in x.items()}, cot.to(DEV)


def sgr_train_bound(s0, mask, steps: int, backward: bool = False) -> dict:
    """The bounds of one reasoning call at the fp32 peak (the kernels' and
    the training path's arithmetic) and at the bf16 peak (the work as
    `itrx` runs it, bf16 operands on the MXU).  Per pair over its n valid
    nodes and per step, the forward does the folded q/k product s M and
    ctx Wg^T (4 n S^2) and the edges and contexts (4 n^2 S); the backward
    recomputes s M and the edges and adds g_pre Wg, the two weight sums and
    g_sm M^T (10 n S^2 in all) and g_a, g_sm and the key-side sums (12 n^2 S
    in all).  Bytes: the nodes, the mask and the steps' weights read once;
    the forward writes every step's fp32 output, the backward reads them
    and the cotangent and writes g_s0 and the weight gradients."""
    b, nn_, s = s0.shape
    n = mask.sum(dim=1).double()
    if backward:
        ops = steps * float((10 * n * s * s + 12 * n * n * s).sum())
    else:
        ops = steps * float((4 * n * s * s + 4 * n * n * s).sum())
    weights = 4 * steps * (3 * s * s + 3 * s)
    saves = 4 * steps * b * nn_ * s
    if backward:
        n_bytes = nbytes(s0, mask) + weights + saves + 4 * b * nn_ * s \
            + s0.numel() * s0.element_size() + weights
    else:
        n_bytes = nbytes(s0, mask) + weights + saves
    b32, b16 = bound(n_bytes, {"fp32": ops}), bound(n_bytes, {"bf16": ops})
    return {"bound_ms": b32["bound_ms"], "bound_by": b32["bound_by"],
            "bound_ms_bf16_peak": b16["bound_ms"], "bound_by_bf16_peak": b16["bound_by"]}


def _sgr_rel(got, want, scale: float) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), SGR_FLOOR * scale)


def phase_sgr(g) -> dict:
    """The training reasoning kernels vs their plain pair: one training
    chunk (4096 pairs, ragged 1-24 words, S 256, sgr_step 3) in fp32 (the
    path's dtype) and bf16, a ragged odd shape and the 129-node limit at
    S 128; the final nodes, all seven cotangents (dbk identically 0) and
    two backward calls bit-identical; then times and bounds at the
    training chunk."""
    log("sgr reasoning forward + backward kernels vs plain (q/k fold, fp32 arithmetic)")
    res = {}
    names = ("g_s0", "dWq", "dbq", "dWk", "dbk", "dWg", "dbg")
    for pairs, l, steps, s in SGR_SHAPES:
        x, cot = _sgr_reason_inputs(g, pairs, l, steps, s)
        for dt in (torch.float32, torch.bfloat16):
            tag = (f"sgr {pairs} pairs x {l + 1} nodes, S {s}, sgr_step {steps} "
                   f"{'bf16' if dt == torch.bfloat16 else 'fp32'}")
            xd = dict(x, s0=x["s0"].to(dt))
            with torch.no_grad():
                got = sgr_reason_fused(**xd)
            want, outs = sgr_reason_plain(**xd)
            bf16 = dt == torch.bfloat16
            e_fwd = check_rel(f"{tag} forward nodes", got, want,
                              SGR_BF16_REL if bf16 else SGR_FWD_REL)
            kb = sgr_reason_bwd_fused(**xd, outs=outs, g=cot)
            pb = sgr_reason_bwd_plain(**xd, outs=outs, g=cot)
            # the fault the limit must separate: one pair's cotangent lost
            lost = cot.clone()
            lost[pairs // 2] = 0.0
            lb = sgr_reason_bwd_plain(**xd, outs=outs, g=lost)
            scale = max(float(t.float().abs().max()) for t in pb)
            if not torch.equal(kb[4], torch.zeros_like(kb[4])):
                raise AssertionError(f"{tag}: dbk is not identically 0")
            errs = {}
            for name, a, w_, c_ in zip(names, kb, pb, lb):
                if name == "dbk":
                    continue
                lim = SGR_BF16_REL if a.dtype == torch.bfloat16 else SGR_BWD_REL
                errs[name] = _sgr_rel(a, w_, scale)
                wrong = _sgr_rel(c_, w_, scale)
                log(f"  {tag} backward {name}: rel_err {errs[name]:.3e} (limit {lim:g}; "
                    f"the plain {name} with pair {pairs // 2}'s cotangent dropped: {wrong:.3e})")
                if not torch.isfinite(a).all() or not errs[name] <= lim:
                    raise AssertionError(f"{tag}: {name} rel_err {errs[name]} > {lim}")
                if not wrong > lim:
                    raise AssertionError(f"the limit {lim} does not separate a lost "
                                         f"pair ({wrong}) in {name}")
            again = sgr_reason_bwd_fused(**xd, outs=outs, g=cot)
            same = all(torch.equal(a, b_) for a, b_ in zip(kb, again))
            log(f"  {tag}: dbk identically 0; two backward calls bit-identical: {same}")
            if not same:
                raise AssertionError(f"{tag}: the backward is not deterministic")
            if (pairs, l, steps, s) == SGR_SHAPES[0] and dt == torch.float32:
                res["max_abs_err"] = float((got - want).abs().max())
                res["fwd_rel_err"] = e_fwd
                res["bwd_max_abs_err"] = max(float((a.float() - w_.float()).abs().max())
                                             for a, w_ in zip(kb, pb))
                res["bwd_rel_err"] = errs
    pairs, l, steps, s = SGR_SHAPES[0]
    x, cot = _sgr_reason_inputs(g, pairs, l, steps, s)
    for dt, suf in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        xd = dict(x, s0=x["s0"].to(dt))
        _, outs = sgr_reason_plain(**xd)
        with torch.no_grad():
            res["ms" + suf] = cuda_ms(lambda: sgr_reason_fused(**xd), reps=10)
            res["plain_ms" + suf] = cuda_ms(lambda: sgr_reason_plain(**xd), reps=5)
        res["bwd_ms" + suf] = cuda_ms(lambda: sgr_reason_bwd_fused(**xd, outs=outs, g=cot),
                                      reps=10)
        res["bwd_plain_ms" + suf] = cuda_ms(
            lambda: sgr_reason_bwd_plain(**xd, outs=outs, g=cot), reps=5)
        for pre, bwd in (("", False), ("bwd_", True)):
            for k, v in sgr_train_bound(xd["s0"], xd["mask"], steps, bwd).items():
                res[pre + k + suf] = v
    res["nodes_per_pair_mean"] = float(x["mask"].sum(dim=1).mean())
    # no single PyTorch call computes the reasoning chain or its backward
    res["library_ms"] = None
    log(f"  time {pairs} pairs x {l + 1} nodes (mean {res['nodes_per_pair_mean']:.2f} valid), "
        f"S {s}, sgr_step {steps}, fp32: forward kernels {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
        f"{res['bound_ms_bf16_peak']:.4f} ms at the bf16 peak); backward kernels "
        f"{res['bwd_ms']:.3f} ms, plain {res['bwd_plain_ms']:.3f} ms, bound "
        f"{res['bwd_bound_ms']:.4f} ms ({res['bwd_bound_by']}; "
        f"{res['bwd_bound_ms_bf16_peak']:.4f} ms at the bf16 peak); bf16 nodes: forward "
        f"{res['ms_bf16']:.3f} ms (plain {res['plain_ms_bf16']:.3f}), backward "
        f"{res['bwd_ms_bf16']:.3f} ms (plain {res['bwd_plain_ms_bf16']:.3f})")
    return res


def sgr_bwd_result(res: dict) -> dict:
    """The backward kernels' row of the kernels line, from the phase's
    result."""
    return {"max_abs_err": res["bwd_max_abs_err"], "ms": res["bwd_ms"],
            "plain_ms": res["bwd_plain_ms"], "bound_ms": res["bwd_bound_ms"],
            "bound_by": res["bwd_bound_by"], "library_ms": None}


def plain_grid(model, imgs, caps, cap_mask, cfg) -> torch.Tensor:
    """The (Ni, Nc) grid through the plain path alone, in cal_sims' length
    buckets: for SCAN the plain version of the config's direction on the
    embeddings upcast to fp32, tiled over captions so the attention tensor
    stays in budget; for SGRAF the model's plain fp32 chain (modules, the
    BatchNorm unfolded) on the same embeddings, chunked by the model."""
    ni, r = imgs.shape[:2]
    sims = torch.empty(ni, caps.shape[0], dtype=torch.float32, device=imgs.device)
    for in_bucket, b in engine.length_buckets(cap_mask, caps.shape[1]):
        idx = torch.from_numpy(in_bucket).to(imgs.device)
        if cfg["name"] == "SGRAF":
            with torch.no_grad():
                sims[:, idx] = model.sim_enc(imgs, caps[idx, :b], cap_mask[idx, :b],
                                             kernel=False)
            continue
        plain = xattn_t2i_plain if cfg["cross_attn"] == "t2i" else xattn_i2t_plain
        tile = max(engine.PLAIN_ATTN_BYTES // (ni * r * b * 4), 1)
        for j0 in range(0, len(idx), tile):
            t = idx[j0:j0 + tile]
            sims[:, t] = plain(
                imgs.float(), caps[t, :b].float(), cap_mask[t, :b], agg_func=cfg["agg_func"],
                lambda_lse=cfg["lambda_lse"], lambda_softmax=cfg["lambda_softmax"],
            )
    return sims


def eval_config(data_root: str, data_name: str, method: str, *overrides: str) -> dict:
    """An evaluation config of `method`'s overlay (encode_bf16 + eval_bf16,
    batch 128, seed 0) over a synthetic split under `data_root`, with the
    repo's vocabularies."""
    return parse_cli(
        ["with", method, f"data_name={data_name}", f"data_path={data_root}",
         f"vocab_path={os.path.join(REPO, 'itrx', 'vocab')}", "vocab_type=json",
         "batch_size=128", "eval_bf16=True", "encode_bf16=True", "seed=0", *overrides],
        make_dirs=False,
    )


def seeded_model(cfg: dict, seed: int):
    return get_model(cfg, device=DEV, generator=torch.Generator().manual_seed(seed))


def grid_of(model, enc: dict, im_div: int, sl: slice = slice(None)) -> torch.Tensor:
    """cal_sims on encoded bf16 embeddings, as evaluate_split forms it."""
    mask = enc["cap_mask"][sl] if "cap_mask" in enc else None
    return engine.cal_sims(model, enc["img"][sl][::im_div], enc["cap"][sl], mask,
                           compute_dtype=torch.bfloat16, verbose=False)


def encode(model, dataset, cfg: dict) -> dict:
    return engine.encode_data(model, dataset, cfg["batch_size"], device=DEV,
                              compute_dtype=torch.bfloat16, encode_dtype=torch.bfloat16)


def _top1(sims, ref) -> tuple:
    """(max |sims - ref|, the share of captions whose top-1 image agrees,
    the distinct top-1 images of `sims`)."""
    top1 = sims.argmax(dim=0)
    return (float((sims - ref).abs().max()), float((top1 == ref.argmax(dim=0)).float().mean()),
            int(torch.unique(top1).numel()))


def grid_witness(model, dataset, cfg, enc, sims, launches) -> tuple:
    """SCAN's and SGRAF's witness: the bf16 kernel grid against the plain
    fp32 grid on the same (bf16-valued) embeddings, within SLICE_MAX_DIFF,
    top-1 agreement >= TOP1_MIN and >= 2 distinct top-1 images.  Returns
    (the fields it measured, the failed checks)."""
    imgs = enc["img"][:: dataset.im_div]
    t0 = time.perf_counter()
    sims32 = plain_grid(model, imgs, enc["cap"], enc["cap_mask"], cfg)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err, agree, distinct = _top1(sims, sims32)
    res32 = metrics.cal_recall(sims32, cap_ratio=dataset.im_div, verbose=False)
    if cfg["name"] == "SGRAF" and cfg["module_name"] == "SGR":
        grid_bound = sgr_bound(imgs, enc["cap"], enc["cap_mask"], cfg["sim_dim"],
                               cfg["sgr_step"])
    elif cfg["name"] == "SGRAF":
        grid_bound = saf_bound(imgs, enc["cap"], enc["cap_mask"], cfg["sim_dim"])
    else:
        grid_bound = xattn_bound(imgs, enc["cap"], enc["cap_mask"], cfg["cross_attn"])
    out = {
        "grid_bound_ms": grid_bound["bound_ms"],
        "grid_bound_by": grid_bound["bound_by"],
        "plain_fp32_sims_seconds": plain_s,
        "rsum_fp32_plain": res32["rsum"],
        "top1_agreement_bf16_kernel_vs_fp32_plain": agree,
        "max_abs_diff_bf16_kernel_vs_fp32_plain": err,
        "distinct_top1_images": distinct,
    }
    problems = []
    if distinct < 2:
        problems.append("every caption ranks the same image first: the witness cannot "
                        "tell a right grid from a degenerate one")
    if not agree >= TOP1_MIN:
        problems.append(f"bf16 kernel grid agrees with the fp32 plain grid on only "
                        f"{agree:.4f} of top-1 images (< {TOP1_MIN})")
    if not err <= SLICE_MAX_DIFF:
        problems.append(f"bf16 kernel grid differs from the fp32 plain grid by {err} "
                        f"(> {SLICE_MAX_DIFF})")
    return out, problems


@contextlib.contextmanager
def _agsa_plain_route():
    """CAMERA's gated attention layers with the kernel's wrapper swapped for
    agsa_attention_plain (plain PyTorch on any device): the same encode's
    plain chain on the card."""
    saved = agsa_model.agsa_attention_fused
    agsa_model.agsa_attention_fused = agsa_attention_plain
    try:
        yield
    finally:
        agsa_model.agsa_attention_fused = saved


def camera_witness(model, dataset, cfg, enc, sims, launches) -> tuple:
    """CAMERA's witnesses (its kernel runs inside encode, in both towers; the
    main path must launch it once a tower and batch).  Witness 1: an fp32
    encode through the kernel against the same encode through
    agsa_attention_plain on the card (embeddings and grid within
    CAMERA_FP32_ATOL, top-1 agreement >= TOP1_MIN, >= 2 distinct top-1
    images).  Witness 2: the bf16 main path's grid against that fp32 grid,
    held to CAMERA_BF16_GRID_ATOL and CAMERA_BF16_TOP1_MIN.  Returns (the
    fields it measured, the failed checks)."""
    want = 2 * -(-len(dataset) // cfg["batch_size"])
    problems = []
    if launches["agsa_attn"] != want:
        problems.append(f"the main path launched agsa_attn {launches['agsa_attn']} times, "
                        f"expected {want}")
    if tuple(enc["img"].shape) != (len(dataset), cfg["smry_k"], cfg["embed_size"]):
        problems.append(f"unexpected image embeddings {tuple(enc['img'].shape)}")

    def grid(e):
        return engine.cal_sims(model, e["img"][:: dataset.im_div], e["cap"], verbose=False)

    reset_counters()
    t0 = time.perf_counter()
    enc32 = engine.encode_data(model, dataset, cfg["batch_size"], device=DEV)
    torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t0
    if read_counters()["agsa_attn"] != want:
        problems.append("the fp32 encode did not launch the kernel in every batch")
    with _agsa_plain_route():
        t0 = time.perf_counter()
        plain32 = engine.encode_data(model, dataset, cfg["batch_size"], device=DEV)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    emb_err = {k: float((enc32[k] - plain32[k]).abs().max()) for k in ("img", "cap")}
    sims32 = grid(enc32)
    w1_err, w1_agree, w1_distinct = _top1(sims32, grid(plain32))
    w2_err, w2_agree, w2_distinct = _top1(sims, sims32)
    out = {
        "fp32_encode_seconds_kernel": fp32_s,
        "fp32_encode_seconds_plain_route": plain_s,
        "rsum_fp32": metrics.cal_recall(sims32, cap_ratio=dataset.im_div, verbose=False)["rsum"],
        "witness1_fp32_embedding_max_abs_diff": emb_err,
        "witness1_fp32_grid_max_abs_diff": w1_err,
        "witness1_top1_agreement": w1_agree,
        "witness1_distinct_top1_images": w1_distinct,
        "witness2_bf16_vs_fp32_grid_max_abs_diff": w2_err,
        "witness2_top1_agreement": w2_agree,
        "witness2_distinct_top1_images": w2_distinct,
    }
    if max(emb_err.values()) > CAMERA_FP32_ATOL or not w1_err <= CAMERA_FP32_ATOL:
        problems.append(f"fp32 kernel encode vs its plain route: embeddings {emb_err}, "
                        f"grid {w1_err} (> {CAMERA_FP32_ATOL})")
    if w1_distinct < 2 or not w1_agree >= TOP1_MIN:
        problems.append(f"fp32 kernel grid vs its plain route: top-1 agreement {w1_agree} "
                        f"(< {TOP1_MIN}) or {w1_distinct} distinct images")
    if not w2_err <= CAMERA_BF16_GRID_ATOL or not w2_agree >= CAMERA_BF16_TOP1_MIN:
        problems.append(f"bf16 main path grid vs the fp32 grid: max diff {w2_err} (limit "
                        f"{CAMERA_BF16_GRID_ATOL}), top-1 agreement {w2_agree} (limit "
                        f"{CAMERA_BF16_TOP1_MIN})")
    return out, problems


# the eval slices: (method overlay, the kernels its evaluate_split must
# launch, config overrides ({data_root} is the split's root), witness)
SLICES = {
    # bench.py's SCAN t2i LSE: unidirectional GRU, the SCAN() overlay defaults
    "t2i": ("SCAN", ("gru", "xattn"), (), grid_witness),
    # SCAN's published i-t AVG (kuanghuei/SCAN README)
    "i2t": ("SCAN", ("gru", "xattn_i2t"),
            ("cross_attn=i2t", "agg_func=Mean", f"lambda_softmax={I2T_SOFTMAX}", "bi_gru=True"),
            grid_witness),
    # SGRAF's published f30k SAF command (Paranioar/SGRAF README: --module_name
    # SAF --sgr_step 3 --max_violation --embed_size 1024 --sim_dim 256), the
    # SGRAF() overlay's defaults: bi_gru, no_txtnorm False
    "saf": ("SGRAF", ("gru", "sgraf_eval_saf"), ("max_violation=True",), grid_witness),
    # SGRAF's published f30k SGR command (the same README: --module_name SGR
    # --sgr_step 3 --max_violation --embed_size 1024 --sim_dim 256)
    "sgr": ("SGRAF", ("gru", "sgraf_eval_sgr"), ("module_name=SGR", "max_violation=True"),
            grid_witness),
    # the CAMERA() overlay at its widths (embed 2048, 64 heads, smry_k 12,
    # max_words 32, BERT-base) with the split's tiny BERT vocabulary; no GRU
    # and no grid kernel: its one kernel runs inside encode
    "camera": ("CAMERA", ("agsa_attn",), ("bert_path={data_root}",), camera_witness),
}


def slice_detail(cfg: dict, model) -> str:
    if cfg["name"] == "CAMERA":
        bert = model.txt_enc.bert.config
        return (f"max_words {cfg['max_words']}, head {cfg['head']}, smry_k {cfg['smry_k']}, "
                f"BERT {bert.hidden_size} x {bert.num_hidden_layers} layers x "
                f"{bert.num_attention_heads} heads")
    if cfg["name"] == "SGRAF":
        return (f"bi_gru={cfg['bi_gru']}, {cfg['module_name']}, sgr_step {cfg['sgr_step']}, "
                f"sim_dim {cfg['sim_dim']}, no_txtnorm {cfg['no_txtnorm']}")
    return (f"bi_gru={cfg['bi_gru']}, {cfg['cross_attn']} {cfg['agg_func']} "
            f"lambda_softmax {cfg['lambda_softmax']}")


def phase_slice(data_root: str, card: str, direction: str) -> tuple:
    """(the slice's result, its bf16 grid): evaluate_split counted, the same
    path timed phase by phase (it must reproduce the ranks), the profiles of
    one encode and one grid, then the slice's witness."""
    method, needs, overrides, witness = SLICES[direction]
    overrides = [o.format(data_root=data_root) for o in overrides]
    forbidden = [k for k in COUNTERS if k not in needs]
    log(f"slice: f30k-1K-shaped {method} {direction} evaluation ({' '.join(overrides)})")
    t0 = time.perf_counter()
    cfg = eval_config(data_root, "f30k_precomp", method, *overrides)
    dataset, vocab_size = get_test_loader("test", cfg)
    cfg["vocab_size"] = vocab_size
    model = seeded_model(cfg, cfg["seed"])
    log(f"  data + model set-up: {time.perf_counter() - t0:.1f} s "
        f"({len(dataset)} captions, vocab {vocab_size}, embed {cfg['embed_size']}, "
        f"{slice_detail(cfg, model)})")

    # the main path, counted: the entry point a user calls, which maps
    # encode_bf16 / eval_bf16 to dtypes and runs encode -> sims -> recall
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = engine.evaluate_split(model, dataset, cfg, device=DEV)
    torch.cuda.synchronize()
    ev_first = time.perf_counter() - t0
    launches = read_counters()
    log(f"  main path (evaluate_split) launches: {launches}")
    if any(launches[k] for k in forbidden):
        raise AssertionError(f"{direction} evaluation launched one of {forbidden}")
    for k in needs:
        if launches[k] <= 0:
            raise AssertionError(f"the main path never launched the {k} kernel")

    # the same path phase by phase, timed, with evaluate_split's dtypes
    def score(enc):
        sims = grid_of(model, enc, dataset.im_div)
        return sims, metrics.cal_recall(sims, cap_ratio=dataset.im_div, verbose=False)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = encode(model, dataset, cfg)
    torch.cuda.synchronize()
    enc_warm = time.perf_counter() - t0
    sims, res = score(enc)
    if res["rsum"] != ev["rsum"] or any(
        not (res[k] == ev[k]).all() for k in ("i2t_ranks", "t2i_ranks")
    ):
        raise AssertionError(f"the timed phases (rsum {res['rsum']}) do not reproduce "
                             f"evaluate_split (rsum {ev['rsum']})")

    imgs = enc["img"][:: dataset.im_div]
    ni, nc = imgs.shape[0], enc["cap"].shape[0]
    if (ni, nc) != (1000, 5000) or tuple(sims.shape) != (ni, nc):
        raise AssertionError(f"unexpected grid {tuple(sims.shape)} for {ni} x {nc}")
    if not (torch.isfinite(sims).all() and torch.isfinite(enc["img"].float()).all()
            and torch.isfinite(enc["cap"].float()).all()):
        raise AssertionError("non-finite embeddings or similarity scores")

    times = []
    while len(times) < 3 and not (times and times[0] > ONE_TIMING_S):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score(enc)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    eval_s = min(times)
    # where the time goes: device time by kernel over one warm run of each
    prof_eval = _profile_steps(lambda _: score(enc), [None])
    prof_encode = _profile_steps(lambda _: encode(model, dataset, cfg), [None])

    seen, problems = witness(model, dataset, cfg, enc, sims, launches)
    out = {
        "card": card,
        "direction": direction,
        "img_embedding_shape": list(imgs.shape),
        "cap_embedding_shape": list(enc["cap"].shape),
        "evaluate_split_seconds_first": ev_first,
        "encode_seconds": enc_warm,
        "eval_seconds": eval_s,
        "eval_seconds_all": times,
        "eval_timed_once": len(times) == 1,
        "pairs_per_sec": ni * nc / eval_s,
        "rsum_bf16_kernel": res["rsum"],
        **seen,
        "mean_per_caption_std_over_images": float(sims.std(dim=0).mean()),
        "launches": launches,
        "profile_eval": prof_eval,
        "profile_encode": prof_encode,
    }
    log(f"{direction} slice result: " + json.dumps(out))
    if problems:
        raise AssertionError(f"{direction} slice: " + "; ".join(problems))
    return out, sims


def save_random_checkpoint(cfg: dict, seed: int, path: str) -> str:
    """A `.pth.tar` of utils/checkpoint holding a model with random weights
    from `seed` and its config."""
    model = seeded_model(cfg, seed)
    save_checkpoint(create_train_state(model, cfg, 1), cfg, 0, 0.0, 0.0, path)
    return path


def ensemble_checkpoints(data_root: str, data_name: str, ck_dir: str) -> tuple:
    """(t2i checkpoint, i2t checkpoint): the two slices' models, each with its
    own config, from seeds 0 and 1."""
    paths = []
    for seed, direction in enumerate(("t2i", "i2t")):
        method, _, overrides, _ = SLICES[direction]
        cfg = eval_config(data_root, data_name, method, *overrides)
        cfg["vocab_size"] = get_test_loader(
            "testall" if data_name == "coco_precomp" else "test", cfg)[1]
        paths.append(save_random_checkpoint(
            cfg, seed, os.path.join(ck_dir, f"{data_name}_{direction}.pth.tar")))
    return tuple(paths)


def models_of(paths) -> list:
    """[(model, config)] of checkpoints, rebuilt as evalrank_ensemble
    rebuilds them."""
    out = []
    for path in paths:
        ck = load_checkpoint(path)
        model = get_model(ck["_config"], device=DEV)
        load_state_list(model, ck["model"])
        out.append((model, ck["_config"]))
    return out


def same_ranks(a: dict, b: dict) -> bool:
    return a["rsum"] == b["rsum"] and all(
        np.array_equal(a[k], b[k]) for k in ("i2t_ranks", "t2i_ranks"))


def phase_ensemble(data_root: str, ck_dir: str, card: str) -> dict:
    """evalrank_ensemble of the t2i LSE and the i2t AVG models on the
    f30k-1K-shaped split: its ranks must be cal_recall of the averaged grids."""
    log("ensemble: t2i LSE + i2t AVG checkpoints through evalrank_ensemble")
    ck_t2i, ck_i2t = ensemble_checkpoints(data_root, "f30k_precomp", ck_dir)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.evalrank_ensemble(ck_t2i, ck_i2t, split="test", device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    log(f"  main path (evalrank_ensemble) launches: {launches}; {seconds:.2f} s")
    for k in ("gru", "xattn", "xattn_i2t"):
        if launches[k] <= 0:
            raise AssertionError(f"the ensemble never launched the {k} kernel")

    (m1, cfg1), (m2, cfg2) = models_of((ck_t2i, ck_i2t))
    dataset, _ = get_test_loader("test", cfg1)
    grids = [grid_of(m, encode(m, dataset, c), dataset.im_div) for m, c in
             ((m1, cfg1), (m2, cfg2))]
    want = metrics.cal_recall((grids[0] + grids[1]) / 2.0, cap_ratio=dataset.im_div,
                              verbose=False)
    singles = [metrics.cal_recall(gr, cap_ratio=dataset.im_div, verbose=False)["rsum"]
               for gr in grids]
    out = {"card": card, "evalrank_ensemble_seconds": seconds, "rsum": res["rsum"],
           "rsum_t2i_alone": singles[0], "rsum_i2t_alone": singles[1],
           "launches": launches}
    log("ensemble result: " + json.dumps(out))
    if not same_ranks(res, want):
        raise AssertionError(f"evalrank_ensemble (rsum {res['rsum']}) is not the recall of "
                             f"the averaged grids (rsum {want['rsum']})")
    return out


def phase_sgraf_ensemble(data_root: str, ck_dir: str, card: str, grids: dict) -> dict:
    """SGRAF's published protocol: the SGR and SAF slices' models (their
    configs and seed) saved as checkpoints and run through
    evalrank_ensemble on the f30k-1K-shaped split; its ranks must be
    cal_recall of the average of the two slices' grids (`grids`, by slice)."""
    log("ensemble: SGRAF-SGR + SGRAF-SAF checkpoints through evalrank_ensemble")
    paths = []
    for direction in ("sgr", "saf"):
        method, _, overrides, _ = SLICES[direction]
        cfg = eval_config(data_root, "f30k_precomp", method, *overrides)
        dataset, cfg["vocab_size"] = get_test_loader("test", cfg)
        paths.append(save_random_checkpoint(
            cfg, cfg["seed"], os.path.join(ck_dir, f"sgraf_{direction}.pth.tar")))
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.evalrank_ensemble(*paths, split="test", device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    log(f"  main path (evalrank_ensemble) launches: {launches}; {seconds:.2f} s")
    for k in ("gru", "sgraf_eval_saf", "sgraf_eval_sgr"):
        if launches[k] <= 0:
            raise AssertionError(f"the SGRAF ensemble never launched the {k} kernel")
    if launches["xattn"] or launches["xattn_i2t"]:
        raise AssertionError("the SGRAF ensemble launched an xattn kernel")
    recall = lambda sims: metrics.cal_recall(sims, cap_ratio=dataset.im_div,  # noqa: E731
                                             verbose=False)
    want = recall((grids["sgr"] + grids["saf"]) / 2.0)
    out = {"card": card, "evalrank_ensemble_seconds": seconds, "rsum": res["rsum"],
           "rsum_sgr_alone": recall(grids["sgr"])["rsum"],
           "rsum_saf_alone": recall(grids["saf"])["rsum"], "launches": launches}
    log("SGRAF ensemble result: " + json.dumps(out))
    if not same_ranks(res, want):
        raise AssertionError(f"evalrank_ensemble (rsum {res['rsum']}) is not the recall of "
                             f"the averaged SGR and SAF grids (rsum {want['rsum']})")
    return out


def phase_fold5(root: str, card: str) -> dict:
    """coco-testall-shaped fold5 (5000 images x 36 x 2048, 25000 captions)
    through evalrank_ensemble: each fold's recall must be that of its own
    averaged grid, and Mean_metrics the mean of the five parts."""
    log("fold5: coco-testall-shaped ensemble (5 folds of 1000 x 5000)")
    t0 = time.perf_counter()
    generate(os.path.join(root, "coco_precomp"), n_images=20000, img_dim=2048,
             splits=("testall",), seed=2, n_concepts_range=(2, 10))
    ck_t2i, ck_i2t = ensemble_checkpoints(root, "coco_precomp", root)
    log(f"  data + checkpoints set-up: {time.perf_counter() - t0:.1f} s")
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.evalrank_ensemble(ck_t2i, ck_i2t, split="testall", fold5=True, device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    log(f"  main path (evalrank_ensemble, fold5) launches: {launches}; {seconds:.2f} s")
    for k in ("gru", "xattn", "xattn_i2t"):
        if launches[k] <= 0:
            raise AssertionError(f"fold5 never launched the {k} kernel")
    if res["data_name"] != "coco_precomp_5fold":
        raise AssertionError(f"fold5 result named {res['data_name']}")

    members = models_of((ck_t2i, ck_i2t))
    dataset, _ = get_test_loader("testall", members[0][1])
    if len(dataset) != 25000:
        raise AssertionError(f"testall has {len(dataset)} captions, expected 25000")
    encs = [encode(m, dataset, c) for m, c in members]
    for i in range(5):
        sl = slice(i * 5000, (i + 1) * 5000)
        avg = (grid_of(members[0][0], encs[0], 5, sl) + grid_of(members[1][0], encs[1], 5, sl)) / 2.0
        want = metrics.cal_recall(avg, verbose=False)
        if tuple(avg.shape) != (1000, 5000) or not same_ranks(res[f"PART_{i + 1}"], want):
            raise AssertionError(f"fold {i + 1}: rsum {res[f'PART_{i + 1}']['rsum']} is not the "
                                 f"recall of its averaged grid ({want['rsum']})")
    mean = res["Mean_metrics"]
    for k, v in mean.items():
        parts = [res[f"PART_{i + 1}"][k] for i in range(5)]
        if abs(v - sum(parts) / 5) > FOLD5_MEAN_ATOL:
            raise AssertionError(f"Mean_metrics[{k}] = {v} is not the mean of the parts {parts}")
    out = {"card": card, "evalrank_ensemble_fold5_seconds": seconds,
           "rsum_parts": [res[f"PART_{i + 1}"]["rsum"] for i in range(5)],
           "mean_rsum": float(mean["rsum"]), "launches": launches}
    log("fold5 result: " + json.dumps(out))
    return out


def _vsrn_dec_inputs(g, t, b, r, h, keep):
    """The decode loop's inputs at the training path's scales: encoder
    outputs and final state in (-1, 1) as a GRU gives them, enc_att from
    them through linear1's encoder half, the word gates, the weights at
    torch's init (linear1 over 2H), and the context-dropout mask pre-scaled
    by 1 / keep (ones at keep 1), with the states' cotangent."""
    def u(lim, *shape):
        return torch.empty(*shape).uniform_(-lim, lim, generator=g)

    k, k2 = 1.0 / math.sqrt(h), 1.0 / math.sqrt(2 * h)
    enc_out = torch.tanh(torch.randn(b, r, h, generator=g) * 0.5)
    w1, b1 = u(k2, h, 2 * h), u(k2, h)
    cmask = torch.ones(t, b, h)
    if keep < 1.0:
        cmask = (torch.rand(t, b, h, generator=g) < keep).float() / keep
    x = {"gxw": torch.randn(t, b, 3 * h, generator=g) * 0.3, "cmask": cmask,
         "enc_out": enc_out, "enc_att": enc_out @ w1[:, :h].t() + b1,
         "h0": torch.tanh(torch.randn(b, h, generator=g) * 0.5), "watt": w1[:, h:],
         "w2": u(k, 1, h), "wctx": u(k, 3 * h, h), "whh": u(k, 3 * h, h), "bhh": u(k, 3 * h)}
    ghs = torch.randn(t, b, h, generator=g)
    return {n: v.to(DEV).contiguous() for n, v in x.items()}, ghs.to(DEV)


def vsrn_dec_bound(x: dict, backward: bool = False) -> dict:
    """The bound of one decode call (fp32): the inputs read once and the
    outputs written once (the forward's states and residuals; the backward's
    ten cotangents), against the products (forward 2 B H^2 x 7 a step:
    h [Watt | Whh]^T and ctx Wctx^T; backward 2 B H^2 x 18: the recomputed
    hq and gx, g_gx Wctx, the carry's [g_hq | g_gh] [Watt ; Whh] and the
    weight sums) and the attention's elementwise work (about 6 and 16
    operations per (b, r, h) a step) at the fp32 peak."""
    t, b, h3 = x["gxw"].shape
    h, r = h3 // 3, x["enc_out"].shape[1]
    ins = nbytes(*x.values())
    if not backward:
        return bound(ins + 4 * t * b * (h + h + h3), {"fp32": t * (14 * b * h * h + 6 * b * r * h)})
    saves = 4 * t * b * (h + h3 + h)  # hall, ghall, g_hs
    outs = ins - nbytes(x["cmask"])  # every input's cotangent but the mask's
    return bound(ins + saves + outs, {"fp32": t * (36 * b * h * h + 16 * b * r * h)})


def phase_vsrn_dec(g) -> dict:
    """VSRN's decoder kernels vs their plain pair: the training path's decode
    (59 steps x 128 x 36 regions, H 512) without and with the context
    dropout, and a ragged odd shape; the states, the residuals, all nine
    cotangents (the mask's zero), two backward calls bit-identical; then the
    times and bounds at the path's shape."""
    log("vsrn_dec decoder forward + backward kernels vs plain (fp32)")
    res = {}
    for t, b, r, h, keep in VSRN_DEC_SHAPES:
        tag = f"vsrn_dec T {t} x B {b} x R {r} x H {h}, keep {keep}"
        x, ghs = _vsrn_dec_inputs(g, t, b, r, h, keep)
        args = tuple(x.values())
        with torch.no_grad():
            got = vsrn_dec_fused(*args)
        k_hs, k_hall, k_ghall = kvsrn._launch_fwd(*args, residuals=True)
        want, hall, ghall = vsrn_dec_plain(*args)
        e_fwd = check_rel(f"{tag} states", got, want, VSRN_FWD_REL)
        for name, a, w in (("states with residuals", k_hs, want), ("hall", k_hall, hall),
                           ("ghall", k_ghall, ghall)):
            check_rel(f"{tag} {name}", a, w, VSRN_FWD_REL)
        kb = vsrn_dec_bwd_fused(*args, hall, ghall, ghs)
        pb = vsrn_dec_bwd_plain(*args, hall, ghall, ghs)
        # the fault the limit must separate: the second step's cotangent lost
        lost = ghs.clone()
        lost[1] = 0.0
        lb = vsrn_dec_bwd_plain(*args, hall, ghall, lost)
        if float(kb[1].abs().max()) != 0.0:
            raise AssertionError(f"{tag}: the mask's cotangent is not 0")
        errs = {}
        for name, a, w_, c_ in zip(VSRN_DEC_NAMES, kb, pb, lb):
            if name == "g_cmask":
                continue
            errs[name] = rel_err(a, w_)
            wrong = rel_err(c_, w_)
            log(f"  {tag} backward {name}: rel_err {errs[name]:.3e} (limit {VSRN_BWD_REL:g}; "
                f"the plain {name} with step 1's cotangent dropped: {wrong:.3e})")
            if not torch.isfinite(a).all() or not errs[name] <= VSRN_BWD_REL:
                raise AssertionError(f"{tag}: {name} rel_err {errs[name]} > {VSRN_BWD_REL}")
            if not wrong > VSRN_BWD_REL:
                raise AssertionError(f"the limit {VSRN_BWD_REL} does not separate a lost "
                                     f"step ({wrong}) in {name}")
        again = vsrn_dec_bwd_fused(*args, hall, ghall, ghs)
        same = all(torch.equal(a, b_) for a, b_ in zip(kb, again))
        log(f"  {tag}: two backward calls bit-identical: {same}")
        if not same:
            raise AssertionError(f"{tag}: the backward is not deterministic")
        if (t, b, r, h, keep) == VSRN_DEC_SHAPES[1]:
            res["max_abs_err"] = float((got - want).abs().max())
            res["fwd_rel_err"] = e_fwd
            res["bwd_max_abs_err"] = max(float((a - w_).abs().max()) for a, w_ in zip(kb, pb))
            res["bwd_rel_err"] = errs
    x, ghs = _vsrn_dec_inputs(g, *VSRN_DEC_SHAPES[1])
    args = tuple(x.values())
    _, hall, ghall = vsrn_dec_plain(*args)
    with torch.no_grad():
        # the training path's forward writes the residuals
        res["ms"] = cuda_ms(lambda: kvsrn._launch_fwd(*args, residuals=True), reps=10)
        res["fwd_no_residuals_ms"] = cuda_ms(lambda: vsrn_dec_fused(*args), reps=10)
        res["plain_ms"] = cuda_ms(lambda: vsrn_dec_plain(*args), reps=5)
    res["bwd_ms"] = cuda_ms(lambda: vsrn_dec_bwd_fused(*args, hall, ghall, ghs), reps=10)
    res["bwd_plain_ms"] = cuda_ms(lambda: vsrn_dec_bwd_plain(*args, hall, ghall, ghs), reps=5)
    res.update(vsrn_dec_bound(x))
    for k, v in vsrn_dec_bound(x, backward=True).items():
        res["bwd_" + k] = v
    # no PyTorch call computes the decode loop or its backward
    res["library_ms"] = None
    t, b, r, h, keep = VSRN_DEC_SHAPES[1]
    log(f"  time T {t} x B {b} x R {r} x H {h} (keep {keep}), fp32: forward kernels "
        f"{res['ms']:.3f} ms with residuals ({res['fwd_no_residuals_ms']:.3f} without), plain "
        f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
        f"backward kernels {res['bwd_ms']:.3f} ms, plain {res['bwd_plain_ms']:.3f} ms, bound "
        f"{res['bwd_bound_ms']:.4f} ms ({res['bwd_bound_by']})")
    return res


def vsrn_bwd_result(res: dict) -> dict:
    """The backward kernels' row of the kernels line, from the phase's
    result."""
    return {"max_abs_err": res["bwd_max_abs_err"], "ms": res["bwd_ms"],
            "plain_ms": res["bwd_plain_ms"], "bound_ms": res["bwd_bound_ms"],
            "bound_by": res["bwd_bound_by"], "library_ms": None}


def _agsa_inputs(g, b, h, n, dk):
    """q, k, v (B, N, h d_k) and the gate's weights at torch's init
    (U(-1/sqrt(d_k), 1/sqrt(d_k)), fc_g's two halves) and biases, fp32."""
    def u(*shape):
        return torch.empty(*shape).uniform_(-dk ** -0.5, dk ** -0.5, generator=g)

    qkv = [torch.randn(b, n, h * dk, generator=g) for _ in range(3)]
    return [t.to(DEV) for t in qkv + [w for _ in range(4) for w in (u(dk, dk), u(dk))]]


def agsa_bound(args) -> dict:
    """The bound of one call: q, k, v, the weights and biases read once and
    the output written once, against the products (four (N, d_k) x (d_k,
    d_k) gate products and the two (N, N, d_k) attention products a head) at
    the peak of the inputs' type."""
    q = args[0]
    b, n, d = q.shape
    dk = args[3].shape[0]
    heads = b * d // dk
    ops = heads * (8 * n * dk * dk + 4 * n * n * dk)
    kind = "bf16" if q.dtype == torch.bfloat16 else "fp32"
    return bound(nbytes(*args) + nbytes(q), {kind: ops})


def phase_agsa(g) -> dict:
    """CAMERA's gated attention kernel vs agsa_attention_plain on the card,
    fp32 and bf16: the image and text towers' calls (128 x 64 heads x 36 or
    32 x d_k 32), a ragged odd shape and the largest the limits allow; then
    the times and bounds at the towers' shapes."""
    log("agsa_attn gated attention kernel vs plain (fp32 and bf16)")
    res = {}
    for b, h, n, dk in AGSA_SHAPES:
        x32 = _agsa_inputs(g, b, h, n, dk)
        for dt, limit in ((torch.float32, AGSA_FP32_REL), (torch.bfloat16, AGSA_BF16_REL)):
            # every input in the activation dtype, as a bf16 encode casts the
            # parameters (the wrapper reads the biases in fp32)
            args = [t.to(dt) for t in x32]
            tag = f"agsa_attn B {b} x h {h} x N {n} x d_k {dk} {str(dt)[6:]}"
            with torch.no_grad():
                got = agsa_attention_fused(*args, h)
                want = agsa_attention_plain(*args, h)
                swapped = args[:7] + [args[9], args[10], args[7], args[8]]
                wrong = rel_err(agsa_attention_plain(*swapped, h).float(), want.float())
            if got.dtype != dt:
                raise AssertionError(f"{tag}: output dtype {got.dtype}")
            err = check_rel(tag, got, want, limit)
            log(f"  {tag}: the plain output with fc_g's halves swapped: {wrong:.3e}")
            if not wrong > limit:
                raise AssertionError(f"the limit {limit} does not separate swapped gate "
                                     f"halves ({wrong})")
            if (b, h, n, dk) in AGSA_SHAPES[:2]:
                key = ("img" if n == AGSA_SHAPES[0][2] else "txt") + "_" + str(dt)[6:]
                with torch.no_grad():
                    res[f"{key}_ms"] = cuda_ms(lambda: agsa_attention_fused(*args, h))
                    res[f"{key}_plain_ms"] = cuda_ms(lambda: agsa_attention_plain(*args, h),
                                                     reps=5)
                bd = agsa_bound(args)
                res[f"{key}_bound_ms"], res[f"{key}_bound_by"] = bd["bound_ms"], bd["bound_by"]
                res[f"{key}_max_abs_err"] = float((got.float() - want.float()).abs().max())
                res[f"{key}_rel_err"] = err
                log(f"  time {tag}: kernel {res[f'{key}_ms']:.4f} ms, plain "
                    f"{res[f'{key}_plain_ms']:.4f} ms, bound {bd['bound_ms']:.4f} ms "
                    f"({bd['bound_by']})")
    # the row of the kernels line: the image tower's call in bf16, the
    # encode_bf16 main path's
    key = "img_bfloat16"
    res.update(max_abs_err=res[f"{key}_max_abs_err"], ms=res[f"{key}_ms"],
               plain_ms=res[f"{key}_plain_ms"], bound_ms=res[f"{key}_bound_ms"],
               bound_by=res[f"{key}_bound_by"])
    # no PyTorch call computes the gated attention (the gates act on q and k
    # before the scores)
    res["library_ms"] = None
    return res


def _losses_from_events(save_dir: str) -> tuple[list, list]:
    """(every logged training loss, every validation rsum) from the run's
    MetricWriter log, in order."""
    losses, rsums = [], []
    with open(os.path.join(save_dir, "events.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "Loss" in rec:
                losses.append(rec["Loss"])
            if "r_sum" in rec:
                rsums.append(rec["r_sum"])
    return losses, rsums


@contextlib.contextmanager
def _sgraf_plain_chain():
    """The SGRAF train tower with its chunk kernels' wrappers swapped for
    their plain pairs (differentiable PyTorch on any device): the same
    step's plain chain on the card."""
    saved = sgraf_model.sgraf_align_fused, sgraf_model.sgr_reason_fused
    sgraf_model.sgraf_align_fused = sgraf_align_plain
    sgraf_model.sgr_reason_fused = lambda *a: sgr_reason_plain(*a)[0]
    try:
        yield
    finally:
        sgraf_model.sgraf_align_fused, sgraf_model.sgr_reason_fused = saved


def _grad_errs(tag, got, want, limit, floor, scale) -> dict:
    """Each gradient's max abs error over the larger of its own largest
    entry and `floor` x scale, held to `limit`; ZERO_GRADS held to noise."""
    errs = {}
    for k in want:
        if k in ZERO_GRADS:
            noise = max(float(got[k].abs().max()), float(want[k].abs().max())) / scale
            log(f"  first step grad {k} (zero in exact arithmetic, {tag}): {noise:.3e} of the "
                f"largest gradient (limit {ZERO_GRAD_REL:g})")
            if not noise <= ZERO_GRAD_REL:
                raise AssertionError(f"{k}: gradient {noise} of scale, expected noise")
            continue
        if not floor:
            errs[k] = check_rel(f"first step grad {k} ({tag})", got[k], want[k], limit)
            continue
        errs[k] = float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()),
                                                               floor * scale)
        log(f"  first step grad {k} ({tag}): {errs[k]:.3e} of the larger of its scale and "
            f"{floor:g} of the largest gradient (limit {limit:g})")
        if not torch.isfinite(got[k]).all() or not errs[k] <= limit:
            raise AssertionError(f"first step grad {k} ({tag}): {errs[k]} > {limit}")
    return errs


def _vsrn_off_identity(model) -> None:
    """Moves VSRN's BatchNorms off their init, the same values on every
    device (drawn on the CPU from a fixed seed): each RsGCN block's W.1 scale
    (zero at init, which makes the block the identity and the gradients of
    its g, theta, phi and W.0 exactly zero) and bias, and every running
    statistic, the f30k `bn`'s too."""
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                c = m.num_features
                m.weight.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=g))
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.empty(c).uniform_(0.5, 2.0, generator=g))


def _first_step_witness(cfg, batch, grad_rel: float = TRAIN_GRAD_REL, floor: float = 0.0,
                        kernel_rel: float | None = None, prepare=None) -> dict:
    """The first training step's loss, gradients and (SGRAF) BatchNorm
    running statistics on the card (the kernels) against the same step on a
    CPU copy (plain path throughout), from one seed's weights and one batch,
    in train mode.  Each gradient's max abs error is held to `grad_rel` of
    the larger of its own largest entry and `floor` of the model's largest
    gradient entry (SGR: see SGR_FLOOR).  With `kernel_rel`, the card's
    gradients are also held to that limit against the same step on the card
    with the SGRAF chunk kernels' plain pairs (`_sgraf_plain_chain`), which
    tells the kernels' share of the card-vs-CPU difference.  `prepare(model)`,
    when given, sets the weights before the step (VSRN: `_vsrn_off_identity`)."""
    def step_on(dev, plain=False):
        model = get_model(cfg, device=dev,
                          generator=torch.Generator().manual_seed(cfg["seed"])).train()
        if prepare is not None:
            prepare(model)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with _sgraf_plain_chain() if plain else contextlib.nullcontext():
            loss, _ = model.loss(b, train=True)
            loss.backward()
        # copies: on the CPU .cpu() would alias the buffers that the next
        # train-mode call updates
        stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        with torch.no_grad():
            e = model.embed(b)
            scores = model.similarity(e["img"], e["cap"], e.get("cap_mask"), train=True)
        # the plain chain leaves bk out of the graph (the fold drops it)
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                 for k, p in model.named_parameters()}
        return loss.detach().cpu(), grads, scores.cpu(), stats

    t0 = time.perf_counter()
    (lk, gk, sk, tk), (lc, gc, sc, tc) = step_on(DEV), step_on(torch.device("cpu"))
    log(f"  first-step witness (card, then a CPU copy): {time.perf_counter() - t0:.1f} s")
    loss_err = abs(float(lk) - float(lc)) / abs(float(lc))
    log(f"  first step loss: card {float(lk):.7f}, cpu {float(lc):.7f}, rel_err "
        f"{loss_err:.3e} (limit {TRAIN_LOSS_REL:g})")
    # hardest negatives (max_violation): a near-tie that the two devices break
    # differently would move a row's gradient; report how many agree
    hn_agree = float(((sk - 1e9 * torch.eye(len(sk))).argmax(1)
                      == (sc - 1e9 * torch.eye(len(sc))).argmax(1)).float().mean())
    log(f"  hardest-negative captions agreeing card vs cpu: {hn_agree:.4f}")
    if not loss_err <= TRAIN_LOSS_REL:
        raise AssertionError(f"first-step loss differs card vs cpu by {loss_err}")
    scale = max(float(g.abs().max()) for g in gc.values())
    kernel_errs, plain_err = {}, None
    if kernel_rel is not None:
        _, gp, _, _ = step_on(DEV, plain=True)
        kernel_errs = _grad_errs("card kernels vs card plain chain", gk, gp, kernel_rel,
                                 floor, scale)
        # the devices' own share, no limit: the same plain chain on both
        plain = {k: float((gp[k] - gc[k]).abs().max()) / max(float(gc[k].abs().max()),
                                                              floor * scale)
                 for k in gc if k not in ZERO_GRADS}
        worst = max(plain, key=plain.get)
        plain_err = plain[worst]
        log(f"  first step grads, the card's plain chain vs cpu (the devices' share, no "
            f"limit): at most {plain_err:.3e} ({worst})")
    grad_errs = _grad_errs("card vs cpu", gk, gc, grad_rel, floor, scale)
    stat_errs = {}
    for k in tc:
        # a running mean is a mean of centred values (~0 by cancellation), so
        # it is held in units of its channel's standard deviation
        var = tc[k.replace("running_mean", "running_var")]
        scale = max(float(tc[k].abs().max()), float(var.max()) ** 0.5)
        stat_errs[k] = float((tk[k] - tc[k]).abs().max()) / scale
        log(f"  first step {k} (card vs cpu): {stat_errs[k]:.3e} of scale "
            f"(limit {TRAIN_STAT_REL:g})")
        if not stat_errs[k] <= TRAIN_STAT_REL:
            raise AssertionError(f"first-step {k} differs card vs cpu by {stat_errs[k]}")
    return {"loss_card": float(lk), "loss_cpu": float(lc), "loss_rel_err": loss_err,
            "grad_rel_err_max": max(grad_errs.values()),
            "stat_rel_err_max": max(stat_errs.values()) if stat_errs else None,
            "kernel_grad_rel_err_max": max(kernel_errs.values()) if kernel_errs else None,
            "plain_chain_grad_rel_err_max": plain_err,
            "hardest_negative_agreement": hn_agree}


def _profile_steps(step_fn, batches) -> dict:
    """Device time by kernel and the idle share over a few steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            step_fn(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # user annotations (Optimizer.step#...) are ranges on the device
        # timeline that overlap its kernels, not device work of their own
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    out = {"steps": len(batches), "wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
           "idle_share": 1.0 - busy_us / 1e6 / wall if rows else None,
           "top_kernels_ms": [[k[:90], round(us / 1e3, 3), n] for us, n, k in rows[:15]]}
    if not rows:
        log("  profiler: no device events (device time not measured)")
    return out


# the training slices: (title, method overlay and overrides, steps of the one
# epoch, validation step, synthetic data seed, kernels the path must launch,
# the launches a step that some of them must show, overrides of the
# first-step witness, the witness's limits and preparation)
TRAIN_SLICES = {
    # SCAN's published f30k t2i command (kuanghuei/SCAN README)
    "scan": ("SCAN f30k t2i training configuration",
             ("SCAN", "bi_gru=True", "max_violation=True"), TRAIN_STEPS, TRAIN_VAL_STEP, 1,
             ("gru", "gru_bwd", "xattn"), {}, {}, {"grad_rel": TRAIN_GRAD_REL}),
    # SGRAF's published f30k SAF command (Paranioar/SGRAF README: --module_name
    # SAF --max_violation --embed_size 1024 --sim_dim 256), the bf16 chain;
    # the witness at dropout 0, since the two devices' random streams differ
    "saf": ("SGRAF-SAF f30k training configuration (sim_bf16)",
            ("SGRAF", "module_name=SAF", "max_violation=True", "sim_bf16=True"),
            SAF_TRAIN_STEPS, SAF_TRAIN_VAL_STEP, 3,
            ("gru", "gru_bwd", "sgraf_align", "sgraf_align_bwd", "sgraf_eval_saf"),
            {"sgraf_align": SGRAF_CHUNKS, "sgraf_align_bwd": SGRAF_CHUNKS},
            {"sgraf_dropout": 0.0},
            {"grad_rel": TRAIN_GRAD_REL_BF16}),
    # SGRAF's published f30k SGR command (Paranioar/SGRAF README: --module_name
    # SGR --sgr_step 3 --max_violation --embed_size 1024 --sim_dim 256), the
    # bf16 alignment chain and the fp32 reasoning kernels; the witness at
    # dropout 0, against the CPU and against the card's plain chain
    "sgr": ("SGRAF-SGR f30k training configuration (sim_bf16)",
            ("SGRAF", "module_name=SGR", "sgr_step=3", "max_violation=True", "sim_bf16=True"),
            SAF_TRAIN_STEPS, SAF_TRAIN_VAL_STEP, 4,
            ("gru", "gru_bwd", "sgraf_align", "sgraf_align_bwd", "sgr", "sgr_bwd",
             "sgraf_eval_sgr"),
            {k: SGRAF_CHUNKS for k in ("sgraf_align", "sgraf_align_bwd", "sgr", "sgr_bwd")},
            {"sgraf_dropout": 0.0},
            {"grad_rel": TRAIN_GRAD_REL_SGR, "floor": SGR_FLOOR,
             "kernel_rel": SGR_KERNEL_GRAD_REL}),
    # VSRN's published f30k command (KunpengLi1994/VSRN README: --data_name
    # f30k_precomp --max_violation --lr_update 10 --max_len 60), the VSRN()
    # overlay: embed 2048, dim_hidden 512, input_dropout_p 0.2, cosine; fp32.
    # The decoder kernels run once a step each; validation runs no kernel but
    # the GRU's.  The witness at input_dropout_p 0 with the RsGCN blocks moved
    # off the identity
    "vsrn": ("VSRN f30k training configuration",
             ("VSRN", "max_violation=True", "lr_update=10", "max_len=60"),
             SAF_TRAIN_STEPS, SAF_TRAIN_VAL_STEP, 5,
             ("gru", "gru_bwd", "vsrn_dec", "vsrn_dec_bwd"),
             {"vsrn_dec": 1, "vsrn_dec_bwd": 1}, {"input_dropout_p": 0.0},
             {"grad_rel": TRAIN_GRAD_REL, "prepare": _vsrn_off_identity}),
}


def phase_train(root: str, card: str, name: str) -> dict:
    """A training slice at full width through fit: one epoch of a synthetic
    split, one validation and checkpoint mid-epoch and one at its end; the
    first-step witness, the counters, finite and falling losses,
    evalrank_single reproducing best_rsum, then the median step time, peak
    memory and a profile of 3 steps."""
    (title, method, steps, val_step, data_seed, used, per_step, witness_cfg,
     limits) = TRAIN_SLICES[name]
    log(f"training slice: {title} at full width")
    t0 = time.perf_counter()
    generate(os.path.join(root, "f30k_precomp"), n_images=steps * 128 // 5, img_dim=2048,
             splits=("train", "dev"), seed=data_seed, n_concepts_range=(2, 10))
    cfg = parse_cli(
        ["with", *method, "data_name=f30k_precomp", f"data_path={root}",
         f"vocab_path={os.path.join(REPO, 'itrx', 'vocab')}", "vocab_type=json",
         "num_epochs=1", f"val_step={val_step}", "log_step=1", f"save_path={root}/runs",
         "seed=0"],
    )
    train_ds, val_ds, vocab_size = get_loaders(cfg)
    cfg["vocab_size"] = vocab_size
    log(f"  data set-up: {time.perf_counter() - t0:.1f} s ({len(train_ds)} train / "
        f"{len(val_ds)} dev captions, vocab {vocab_size}); batch {cfg['batch_size']}, "
        f"embed {cfg['embed_size']}, word_dim {cfg['word_dim']}, img_dim {cfg['img_dim']}, "
        f"lr {cfg['learning_rate']}, clip {cfg['grad_clip']}, train_bf16 "
        f"{cfg['train_bf16']}, sim_bf16 {cfg['sim_bf16']}, sim_dim {cfg['sim_dim']}, "
        f"cap_chunk {cfg['cap_chunk']}")

    first = next(train_ds.train_batches(cfg["batch_size"], cfg["seed"], 0))
    witness = _first_step_witness(dict(cfg, **witness_cfg), first, **limits)

    # the main path, counted: the port's train entry
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, best_rsum = fit(cfg, train_ds, val_ds, device=DEV)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counters()
    log(f"  main path (fit, 1 epoch) launches: {launches}; {fit_s:.2f} s")
    for k in COUNTERS:
        if k in used and launches[k] <= 0:
            raise AssertionError(f"the training path never launched the {k} kernel")
        if k not in used and launches[k]:
            raise AssertionError(f"the training path launched the {k} kernel")
    for k, n in per_step.items():
        if launches[k] != n * steps:
            raise AssertionError(f"{k}: {launches[k]} launches, expected {n} a step")
    if state.step != steps:
        raise AssertionError(f"fit ran {state.step} steps, expected {steps}")

    losses, rsums = _losses_from_events(cfg["save_dir"])
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"expected {steps} finite losses, got {losses}")
    w = steps // 5
    first_w, last_w = statistics.mean(losses[:w]), statistics.mean(losses[-w:])
    log(f"  loss: first {losses[0]:.4f}, mean of first {w} {first_w:.4f}, of last {w} "
        f"{last_w:.4f}; validation rsums {rsums}")
    if not last_w < first_w:
        raise AssertionError(f"the loss did not fall: {first_w} -> {last_w}")
    if len(rsums) != 2:
        raise AssertionError(f"expected one validation mid-epoch and one at its end, "
                             f"got {rsums}")

    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    for path in (best, os.path.join(cfg["save_dir"], "epo0_checkpoint.pth.tar")):
        if not os.path.exists(path):
            raise AssertionError(f"missing checkpoint {path}")
    ckpt = load_checkpoint(best)
    ev = engine.evalrank_single(best, split="dev", device=DEV)
    log(f"  evalrank_single(model_best.pth.tar): rsum {ev['rsum']}, checkpoint "
        f"best_rsum {ckpt['best_rsum']} (Eiters {ckpt['Eiters']})")
    if abs(ev["rsum"] - ckpt["best_rsum"]) > 1e-6 or ckpt["best_rsum"] != best_rsum:
        raise AssertionError("evalrank_single does not reproduce the checkpoint's best_rsum")

    # step time after warm-up (host clock, each step ending in a synchronize)
    step_fn = make_train_step(state, cfg["seed"])
    it = prefetch(train_ds.train_batches(cfg["batch_size"], cfg["seed"], 1), DEV)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(next(it))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times[2:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile_steps(step_fn, [next(it) for _ in range(3)])
    out = {
        "card": card,
        "steps": steps,
        "fit_seconds": fit_s,
        "step_seconds_median": step_s,
        "step_seconds": times,
        "samples_per_sec": cfg["batch_size"] / step_s,
        "peak_memory_gb": peak,
        "loss_first": losses[0], f"loss_mean_first{w}": first_w,
        f"loss_mean_last{w}": last_w, "val_rsums": rsums, "best_rsum": best_rsum,
        "witness": witness, "profile": prof, "launches": launches,
    }
    log(f"{name} training result: " + json.dumps(out))
    return out


def main():
    card = phase_device()
    phase_build()
    g = torch.Generator().manual_seed(0)
    results = {"gru": phase_gru(g), "gru_bwd": phase_gru_bwd(g), "xattn": phase_xattn(g),
               "xattn_i2t": phase_xattn_i2t(g), "sgraf_eval_saf": phase_sgraf_eval_saf(g),
               "sgraf_eval_sgr": phase_sgraf_eval_sgr(g), "sgraf_align": phase_sgraf_align(g)}
    results["sgraf_align_bwd"] = align_bwd_result(results["sgraf_align"])
    results["sgr"] = phase_sgr(g)
    results["sgr_bwd"] = sgr_bwd_result(results["sgr"])
    results["vsrn_dec"] = phase_vsrn_dec(g)
    results["vsrn_dec_bwd"] = vsrn_bwd_result(results["vsrn_dec"])
    results["agsa_attn"] = phase_agsa(g)
    # the GRU kernels at VSRN's text width (H 2048, 61 slots; the region GRU is
    # the same recurrence over 36 steps)
    phase_gru_bwd(g, b=128, l=61, d=300, h=2048, timed=False)
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_") as data_root:
        # bench.py's split: 4000 // 4 = 1000 test images x 36 x 2048, 5000 captions
        generate(os.path.join(data_root, "f30k_precomp"), n_images=4000, img_dim=2048,
                 splits=("test",), seed=0, n_concepts_range=(2, 10))
        write_tiny_bert_vocab(os.path.join(data_root, "vocab.txt"))  # CAMERA's BERT
        phase_slice(data_root, card, "t2i")
        i2t, _ = phase_slice(data_root, card, "i2t")
        saf, saf_sims = phase_slice(data_root, card, "saf")
        sgr, sgr_sims = phase_slice(data_root, card, "sgr")
        cam, _ = phase_slice(data_root, card, "camera")
        phase_ensemble(data_root, data_root, card)
        phase_sgraf_ensemble(data_root, data_root, card, {"sgr": sgr_sims, "saf": saf_sims})
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_fold5_") as root:
        phase_fold5(root, card)
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_train_") as root:
        tr = phase_train(root, card, "scan")
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_train_saf_") as root:
        tr_saf = phase_train(root, card, "saf")
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_train_sgr_") as root:
        tr_sgr = phase_train(root, card, "sgr")
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_train_vsrn_") as root:
        tr_vsrn = phase_train(root, card, "vsrn")
    # launches: each kernel's count from the main path that runs it (SCAN's
    # training path for the GRU kernels and t2i validation, the i2t slice's
    # evaluate_split for xattn_i2t, the SAF and SGR slices' for their eval
    # kernels, SGRAF-SAF's training path for the alignment kernels,
    # SGRAF-SGR's for the reasoning kernels, VSRN's for the decoder kernels,
    # the CAMERA slice's evaluate_split for agsa_attn)
    launches = dict(tr["launches"], xattn_i2t=i2t["launches"]["xattn_i2t"],
                    sgraf_eval_saf=saf["launches"]["sgraf_eval_saf"],
                    sgraf_eval_sgr=sgr["launches"]["sgraf_eval_sgr"],
                    sgraf_align=tr_saf["launches"]["sgraf_align"],
                    sgraf_align_bwd=tr_saf["launches"]["sgraf_align_bwd"],
                    sgr=tr_sgr["launches"]["sgr"], sgr_bwd=tr_sgr["launches"]["sgr_bwd"],
                    vsrn_dec=tr_vsrn["launches"]["vsrn_dec"],
                    vsrn_dec_bwd=tr_vsrn["launches"]["vsrn_dec_bwd"],
                    agsa_attn=cam["launches"]["agsa_attn"])
    log(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"itrx_torch/csrc/{SOURCES[name]}",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"library_call": r["library_call"]} if "library_call" in r else {}),
        }
        for name, r in results.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
