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
   warm-up).  The GRU forward is held to gru_scan at every shape of
   GRU_FWD_SHAPES (H 256, 512, 1024, 2048 and a ragged 1036; B 128, 8
   and 1; D 300, and SAEM's 768 and 2048), bf16 and fp32, both
   directions, each printed with its plan (route, blocks, shared memory),
   its time a step, cuDNN's and its bound; a grid
   that cannot be co-resident must raise.  The GRU adjoint is held to
   autograd through the plain GRU (all five gradients, both directions) and
   to gru_bwd_plain at GRU_BWD_SHAPES, two calls bit-identical; the SCAN
   t2i and i2t score kernels to `xattn_t2i_plain` / `xattn_i2t_plain` at
   XATTN_SHAPES (64 x 320 and 37 x 211 at L 24, L 128, L 21 and 2, padded
   by the wrapper to multiples of 8), both aggregations, bf16 and fp32, two
   calls bit-identical, timed (medians of 5) beside the earlier design and
   cuBLAS's A product alone; the SGRAF-SAF and SGRAF-SGR score
   kernels to `sgraf_eval_saf_plain` and `sgraf_eval_sgr_plain` at D 1024,
   S 256 (SGR at sgr_step 3, and 1 at the ragged shape), bf16 and fp32,
   SAF also at L 4, at a 128-word caption and at S 128, SGR at the last two
   in bf16, and repeat launches bit-identical; the SGRAF training
   alignment kernels (forward and backward) to `sgraf_align_plain` and
   `sgraf_align_bwd_plain` (all four gradients, two forward and two
   backward calls bit-identical, the forward's masked words exactly zero
   over NaN-filled memory) at one training chunk, 32 captions x 128 images
   x 24 words, and at a ragged odd shape, bf16 and fp32, with both kernels'
   device time by launch (torch.profiler over the timed calls), their
   products' TFLOP/s and share of the bound, one forward and one backward
   call under torch.cuda.set_sync_debug_mode("error") (no device-to-host
   sync), and in
   bf16 a float64 witness (gcap and gimg of the kernel and of the plain
   version, each against a float64 plain run on the same values); the SGR training
   reasoning kernels to `sgr_reason_plain` and `sgr_reason_bwd_plain`
   (the final nodes and every step's save, the saves' masked rows exactly
   zero over NaN-filled memory, two forward calls bit-identical; all seven
   cotangents, dbk identically 0, two backward calls bit-identical) at one
   training chunk, 4096 pairs x 25 nodes, S 256, sgr_step 3, at a ragged
   odd shape and at 129 nodes (S 128 and S 256, each kernel's staged and
   streamed edge routes), fp32 and bf16, with both kernels' device time by
   launch (profiler), their products' TFLOP/s and share of the bound, and
   one forward and one backward call under
   torch.cuda.set_sync_debug_mode("error");
   VSRN's caption-decoder kernels to `vsrn_dec_plain` and
   `vsrn_dec_bwd_plain` (the states and residuals, all nine cotangents, two
   forward and two backward calls bit-identical) at the training path's
   decode, 59 steps x 128 x 36 regions, H 512, without and with the context
   dropout, and at a ragged odd shape, both also at the loops' other routes
   (VSRN_DEC_ROUTE_SHAPES: H 1024 with weights streamed, 128 regions, B 200;
   one and two blocks a unit slice over several batch tiles), with each
   one's device time by launch (profiler), its products' TFLOP/s and share
   of the bound, and one call of each under
   torch.cuda.set_sync_debug_mode("error"); CAMERA's AGSA gated attention kernels to
   `agsa_attention_plain` and `agsa_attention_bwd_plain` (all eleven
   cotangents, two forward and two backward calls bit-identical) at both
   towers' calls on the evaluation and training paths (128 x 64 heads x 36
   regions or 32 BERT slots x d_k 32), at B 129 (not a multiple of the
   kernels' persistent grid), at a ragged odd shape and at the largest shape
   their limits allow (N 64, d_k 128), bf16 and fp32 (the forward equal to
   the plain one bit for bit at the towers' calls and at B 129, the count
   of differing elements printed everywhere), with each launch plan and
   SDPA on the gated image-tower qm, km as a yardstick of the attention
   half alone; the bf16 modes of train_bf16's path: the GRU adjoint with
   bf16 W_hh (GRU_BF16_BWD_SHAPES: SCAN's 128 x 48 x H 1024 and VSRN's two
   H 2048 calls, resident) against gru_bwd_plain at bf16 dot on the bf16
   forward kernel's residuals, two calls bit-identical, timed beside the
   fp32 adjoint and cuDNN's bf16 GRU, and VSRN's decoder pair in its
   bf16-operand mode (VSRN_DEC_BF16_SHAPES) against the plain pair at bf16
   dot, timed beside the fp32 mode; each printed with the share of entries
   that differ and the same plain version without the bf16 roundings; and
   the GRU kernels
   at VSRN's text width (H 2048, 61 steps, fp32: the streamed route)
   against autograd through the plain GRU, timed beside cuDNN;
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
   first reading on the card).  Then the VSRN slice (the VSRN() overlay:
   embed 2048, the text and region GRUs at H 2048 in bf16, TorchBatchNorm on
   bf16, its text GRU made a slow integrator so that random weights do not
   embed every caption alike: _vsrn_text_memory): the counters show gru and
   no other kernel; its witness is the grid of the same encode with the GRU
   swapped for its plain pair on the card (top-1 agreement >= 0.95, >= 2
   distinct top-1 images, embeddings within 2^-7).
   Then the SAEM slices (the SAEM() overlay: final_dims 256, the cnn text
   head over BERT-base with the split's tiny vocabulary, the trans image
   branch from the port's trans_cfg, max_words 32, BERT's word embeddings
   scaled by 10 so that random weights do not embed every caption alike:
   _saem_word_scale; no kernel; its witness the bf16 grid against an fp32
   encode and grid of the same model, top-1 agreement >= 0.95, the fp32
   top-1 among the bf16 top 5 on >= 0.99) and again with both rnn heads
   (bi_gru: the GRU kernel over BERT's last layer at H 1024 and over the
   regions at H 256, 160 launches; the witness also against the same
   encode through the plain GRU), and the VSE++ slice (the VSE_PP() overlay over a flat split,
   1000 images x one 4096-d vector, its word embeddings scaled by 10 so
   that random weights do not embed every caption alike:
   _vsepp_word_scale; the GRU kernel at H 1024 in bf16, 40 launches; the
   witness against the plain GRU's encode);
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
   BatchNorm statistic);
10. the CAMERA training slice: the README's CAMERA command (the CAMERA()
   overlay: embed 2048, 64 heads, smry_k 12, smry_lamda 0.01, max_words 32,
   drop 0, BERT-base frozen over the split's tiny vocabulary, 36 x 2048
   regions with boxes, batch 128, Adam 1e-4, clip 2.0, fp32), one 25-step
   epoch through fit with validation at step 15 and the end: the counters
   show agsa_attn_bwd twice a step and agsa_attn in training and
   validation, and no other kernel; BERT's parameters leave fit as the seed
   drew them, with no Adam state; the first step's loss and the AGSA and
   text BatchNorms' statistics match a CPU copy, every gradient matches a
   float64 copy of the step on the CPU that takes the card's ReLU
   decisions, and all of them match the same step on the card with the
   AGSA kernels swapped for their plain pair;
11. the VSE++ training slice: VSE++'s f30k_precomp command (max_violation,
   batch 128, lr 2e-4, embed 1024, word_dim 300, fp32) over a flat split,
   one 25-step epoch through fit with validation at step 15 and the end:
   the counters show the GRU forward once a step and once a validation
   batch and the adjoint once a step, and no other kernel; the first step
   matches a CPU copy;
12. the SAEM training slice: the SAEM() overlay (batch 64, lr 1e-4), fp32,
   one 25-step epoch: no kernel; BERT leaves fit as the seed drew it, with
   no Adam state; the first step (every dropout at 0, the angular loss at
   epoch 0's weight) matches a CPU copy.  Each new slice's encode, eval,
   pairs/s and step seconds are printed with the card's name and power
   limit;
13. train_bf16 (train/loop.py::cast_loss, `itrx`'s
   make_train_step(compute_dtype="bfloat16")): VSRN's, SCAN's and CAMERA's
   commands with train_bf16=True through fit, 25 steps each (the GRU pair
   at H 2048 and the decoder pair in their bf16 modes; the GRU pair and
   xattn in validation; the AGSA pair in bf16), each with the counters,
   falling losses, evalrank_single reproducing best_rsum, fp32 masters,
   BatchNorm buffers and Adam moments after fit, and _bf16_step_witness:
   the first bf16 step against the same cast step on a CPU copy (loss,
   every gradient against bf16's own distance from the fp32 step, the
   statistics written back as bf16 values), the bf16 loss within 3% of
   the fp32 one; then 3 steps under train_bf16 of SGRAF-SGR (sim_bf16),
   VSE++ and SAEM (phase_bf16_steps: finite losses, their kernels'
   counters, fp32 masters).

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import functools
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
from itrx_torch.models.layers import SeededDropout, TorchBatchNorm
from itrx_torch.ops import kernels
from itrx_torch.ops.kernels import gru as kgru
from itrx_torch.ops.kernels.gru import gru_bwd_fused, gru_scan_fused
from itrx_torch.ops.kernels import sgraf_eval as ksgraf_eval
from itrx_torch.ops.kernels import vsrn_dec as kvsrn
from itrx_torch.ops.kernels.agsa_attn import _chain as agsa_chain
from itrx_torch.ops.kernels.agsa_attn import (agsa_attention_bwd_fused, agsa_attention_bwd_plain,
                                              agsa_attention_fused, agsa_attention_plain)
from itrx_torch.ops.kernels.agsa_attn import fwd_plan as agsa_fwd_plan
from itrx_torch.ops.kernels.agsa_attn import plan as agsa_plan
from itrx_torch.ops.kernels.sgr import (card_plan, edge_blocks, edge_bounds, row_list,
                                        sgr_reason_bwd_fused, sgr_reason_bwd_plain,
                                        sgr_reason_fused, sgr_reason_fwd_fused,
                                        sgr_reason_plain)
from itrx_torch.ops.kernels.sgraf_align import (sgraf_align_bwd_fused, sgraf_align_bwd_plain,
                                                sgraf_align_fused, sgraf_align_plain)
from itrx_torch.ops.kernels.sgraf_eval import (sgraf_eval_saf_fused, sgraf_eval_saf_plain,
                                               sgraf_eval_sgr_fused, sgraf_eval_sgr_plain)
from itrx_torch.ops.kernels.vsrn_dec import (vsrn_dec_bwd_fused, vsrn_dec_bwd_plain,
                                             vsrn_dec_fused, vsrn_dec_plain)
from itrx_torch.ops.kernels.xattn import (xattn_i2t_fused, xattn_i2t_plain,
                                          xattn_t2i_fused, xattn_t2i_plain)
from itrx_torch.ops.rnn import gru_bwd_plain, gru_fwd_plain, gru_scan
from itrx_torch.train.loop import cast_loss, fit, make_train_step, prefetch
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint, load_state_list, save_checkpoint

REPO = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda", 0)
TOP1_MIN = 0.95
# A bf16 encode through the GRU kernel against the same encode through its
# plain pair: the unit-norm embeddings' entries lie below 1, where a bf16 ulp
# is at most 2^-8, and the two routes differ by rounding flips of the carry
# that move an entry by an ulp or two (read 4.9e-4 to 2.0e-3 on the H100 in
# the VSRN, VSE++ and SAEM rnn slices); a wrong row is off by the entries'
# own size, ~width^-1/2 >= 2.2e-2 at the widest embedding (2048)
GRU_EMBED_BF16_ATOL = 2.0 ** -7
# SAEM's bf16 encode runs BERT-base's twelve layers in bf16 (caption
# embeddings ~1% off the fp32 encode's), so its top-1 flips between images
# tied to that; the fp32 top-1 image must stay among the bf16 grid's top 5
# (read on every caption on the card: 1.0)
SAEM_TOP5_MIN = 0.99
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
    f"img_enc.Rs_GCN_{i}.W.0.bias" for i in range(1, 5)) + (
    # CAMERA: the value projection's bias shifts every attention output row
    # alike (softmax rows sum to 1), as fc2's does, before a train-mode
    # BatchNorm
    "img_enc.agsa.att_layers.0.linears.2.bias", "txt_enc.agsa.att_layers.0.linears.2.bias",
    "txt_enc.fc2.bias",
    # SAEM: a transformer block's key bias adds one constant to each query's
    # scores, which the softmax takes out
    "img_enc.layer.attention.self.key.bias", "txt_enc.layer.attention.self.key.bias")
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
# and every step's save (relu outputs, entries up to ~1), max|kernel -
# plain| / max|plain|, differ by the split products' rounding (~5e-6 through
# sgr_step 3 in tests/test_torch_sgr_fwd_split.py's emulation; one bf16
# pass 2e-3) and summation order; the backward's seven cotangents, per tensor
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
# longest caption the kernels take (128 words, 129 nodes) at S 128 (the
# backward's streamed edge route, the forward's staged one) and at S 256
# (both kernels' streamed route)
SGR_SHAPES = ((32 * 128, 24, 3, 256), (185, 21, 1, 256), (64, 128, 2, 128), (32, 128, 2, 256))
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
# the backward's other loop routes, held within VSRN_BWD_REL too (inputs
# from a generator of their own): H 1024 (its weight fragments streamed,
# one block a unit slice) with the most regions and two 128-row batch tiles;
# one block a slice with the fragments resident; two blocks a slice with
# several 64-row tiles each
VSRN_DEC_ROUTE_SHAPES = ((5, 200, 128, 1024, 0.8), (4, 40, 7, 600, 1.0), (3, 300, 36, 64, 0.5))
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
# The backward kernels vs agsa_attention_bwd_plain on the same inputs, per
# cotangent max|kernel - plain| / max|plain|: in fp32 summation order (the
# weight cotangents sum 294,912 rows at the image tower's call, in tiles,
# block slots and an ordered reduction against the plain version's
# products); in bf16 dq, dk and dv are rounded on both sides and an
# intermediate on a rounding boundary (rnd(g_s), rnd(g_z), rnd(g_gq)) may
# round apart, one bf16 step (2^-8 of scale).  The plain backward with fc_g's
# halves swapped is printed beside each reading and must exceed the limit
AGSA_BWD_REL = 1e-4
AGSA_BWD_BF16_REL = 2.0 ** -8
AGSA_BWD_NAMES = ("dq", "dk", "dv", "dWq", "dbq", "dWk", "dbk", "dWg1", "dbg1", "dWg2", "dbg2")
# (B, h, N, d_k): the image and text towers' calls on CAMERA's eval and
# training paths (the CAMERA() overlay: batch 128, 64 heads, 36 regions or 32
# BERT slots, embed 2048), a ragged odd shape and the largest shape the
# limits allow
AGSA_SHAPES = ((128, 64, 36, 32), (128, 64, 32, 32), (5, 3, 7, 8), (4, 2, 64, 128))
# the image tower's call at a batch whose heads (129 x 64) are not a multiple
# of the kernels' persistent grid (a block walks heads grid apart)
AGSA_RAGGED_GRID = (129, 64, 36, 32)
# the forward keeps the plain version's order of operations element by
# element (csrc/agsa_attn.cu), so at these calls (the towers' and the B 129
# grid), both dtypes, it must equal agsa_attention_plain bit for bit, beside
# the limits above; elsewhere the differing elements are printed
AGSA_EXACT_SHAPES = AGSA_SHAPES[:2] + (AGSA_RAGGED_GRID,)
# the PR 11-12 designs (fp32 FMAs, one output element a thread; the
# backward three launches with a 75 MB workspace) at the towers' calls, ms
# image / text (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's:
# the earlier column of both kernels
AGSA_FMA_MS = {"fwd_bfloat16": (0.882, 0.728), "fwd_float32": (1.015, 0.771),
               "bwd_float32": (2.674, 2.087), "bwd_bfloat16": (2.845, 2.258)}
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
# CAMERA training's first-step witness (fp32).  Read on an H100 80GB HBM3 at
# 700 W, the slice's first run: the card's step with the AGSA kernels
# against the same step with their plain pair on the card (the kernels'
# share: summation order in the attention and the weight sums) at most
# 2.7e-5 of a gradient's scale (the image key projection's bias, a
# cancellation), held within CAMERA_KERNEL_GRAD_REL; the same plain chain on
# the card and on the CPU up to 3.6e-3 (the text fc1 weight).  That gap is
# ReLU decisions: the summarization's banks and text fc1 feed ReLUs, whose
# gradient turns on the sign of a pre-activation that rounding can flip,
# and their weight gradients cancel (train-mode BatchNorms after them).
# Against a float64 copy of the step on the CPU the card flipped 10 of
# fc1's 8.4 M decisions, 3 after the 5th bank and 1 after the 7th, the fp32
# CPU 5, 1 and 0, and the flips moved those weights' gradients by up to
# 3.2e-3 of scale.  So the float64 step takes the card's ReLU decisions (`exact`:
# the modules that feed a ReLU; `_relu_decision`), the flips are counted on
# each device, and every trained gradient of the card is held within
# EXACT_GRAD_REL of its float64 scale: read at most 3.5e-5 and 5.1e-5 in two
# calls (the image key projection's bias); TF32 rounds each product to 2^-11 = 4.9e-4
CAMERA_KERNEL_GRAD_REL = 1e-4
EXACT_GRAD_REL = 2e-4
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
    "agsa_attn_bwd": "itrx/ops/pallas/agsa_attn.py:86 (_bwd_kernel)",
}
SOURCES = {"gru": "gru.cu", "gru_bwd": "gru_bwd.cu", "xattn": "xattn.cu",
           "xattn_i2t": "xattn_i2t.cu", "sgraf_eval_saf": "sgraf_eval_saf.cu",
           "sgraf_eval_sgr": "sgraf_eval_sgr.cu", "sgraf_align": "sgraf_align.cu",
           "sgraf_align_bwd": "sgraf_align_bwd.cu", "sgr": "sgr.cu", "sgr_bwd": "sgr_bwd.cu",
           "vsrn_dec": "vsrn_dec.cu", "vsrn_dec_bwd": "vsrn_dec_bwd.cu",
           "agsa_attn": "agsa_attn.cu", "agsa_attn_bwd": "agsa_attn_bwd.cu"}
# the kernels line's rows of bf16 modes, by the kernel whose source, TPU
# kernel and wrapper they share; the wrapper counts their launches among its
# own and also in its bf16_launches
MODE_OF = {"gru_bwd_bf16": "gru_bwd", "vsrn_dec_bf16": "vsrn_dec",
           "vsrn_dec_bwd_bf16": "vsrn_dec_bwd"}
COUNTERS = {"gru": gru_scan_fused, "gru_bwd": gru_bwd_fused, "xattn": xattn_t2i_fused,
            "xattn_i2t": xattn_i2t_fused, "sgraf_eval_saf": sgraf_eval_saf_fused,
            "sgraf_eval_sgr": sgraf_eval_sgr_fused, "sgraf_align": sgraf_align_fused,
            "sgraf_align_bwd": sgraf_align_bwd_fused, "sgr": sgr_reason_fused,
            "sgr_bwd": sgr_reason_bwd_fused, "vsrn_dec": vsrn_dec_fused,
            "vsrn_dec_bwd": vsrn_dec_bwd_fused, "agsa_attn": agsa_attention_fused,
            "agsa_attn_bwd": agsa_attention_bwd_fused}
# the SAF and SGR kernels' earlier design (their products on fp32 FMAs) at
# 64 x 320 x 36 x 24 x 1024, S 256, sgr_step 3 (ms, bf16 and fp32; NVIDIA
# H100 80GB HBM3, 700 W), printed beside this run's
SGRAF_EVAL_FMA_MS = {"saf": (12.642, 18.232), "sgr": (24.046, 29.145)}
# the alignment forward's earlier design (its projection and context on fp32
# FMAs, the output zeroed by a memset) and the backward's (five passes of
# fp32-FMA products) at one training chunk (ms, bf16 and fp32; NVIDIA H100
# 80GB HBM3, 700.00 W), printed beside this run's
ALIGN_FWD_FMA_MS = (2.395, 3.522)
ALIGN_BWD_FMA_MS = (12.659, 15.660)
# the SGR reasoning forward's and backward's earlier designs (three and six
# launches a step, their products on fp32 FMAs) at one training chunk (ms,
# fp32 and bf16 nodes; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this
# run's
SGR_FWD_FMA_MS = (2.690, 2.734)
SGR_BWD_FMA_MS = (9.511, 9.425)
# the VSRN decoder backward's earlier design (four launches a step on 16
# SMs, fp32-FMA products) at the training path's decode, T 59 x B 128 x R 36
# x H 512, keep 0.8 (ms, fp32; NVIDIA H100 80GB HBM3, 700.00 W), printed
# beside this run's
VSRN_BWD_FMA_MS = 37.474
# the VSRN decoder forward's earlier design (three launches a step, fp32-FMA
# products on 16 to 64 blocks) at the same decode, with and without the
# residuals (ms, fp32; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this
# run's
VSRN_FWD_PER_STEP_MS = (11.535, 11.167)
# builds of the SAF kernel for measurements only (kernels.load(name,
# defines)): its tile epilogues cut, and the projection cut too (the phases
# of its time)
SAF_NO_POOL = ("ITRX_SAF_NO_POOL",)
SAF_NO_PROJECT = ("ITRX_SAF_NO_PROJECT",)
SAF_VARIANTS = (SAF_NO_POOL, SAF_NO_PROJECT)
# the GRU kernels this design replaced (one launch a timestep) at phase_gru's
# main shape (forward bf16, fp32; input projection included) and
# phase_gru_bwd's (adjoint; forward + backward through autograd): ms,
# NVIDIA H100 80GB HBM3, 700 W; printed beside this run's
GRU_PER_STEP_FWD_MS = (2.342, 2.381)
GRU_PER_STEP_BWD_MS = (9.870, 16.295)
# (B, L, D, H) the GRU forward is held and timed at, bf16 and fp32, both
# directions, ragged lengths: encode's batch (SCAN, SGRAF and VSE++ H 1024),
# the last batch of encode's 128-row batches over 5000 captions, one row,
# VSRN's decoder-side GRU (H 512, 36 regions), VSRN's text and region width
# (H 2048: bf16 resident, fp32 streamed), SAEM's rnn heads at encode's batch
# (the regions: D 2048, H final_dims 256, 36 steps; BERT's last layer: D 768,
# H embed_size 1024, its 32 slots) and an H that is not a multiple of the
# unit group
GRU_FWD_SHAPES = ((128, 24, 300, 1024), (8, 24, 300, 1024), (1, 24, 300, 1024),
                  (128, 36, 300, 512), (128, 36, 300, 2048), (128, 36, 2048, 256),
                  (128, 32, 768, 1024), (37, 21, 300, 1036))
# (B, L, H) the adjoint is held at besides phase_gru_bwd's timed shapes, both
# directions: the ragged tails and one row at H 1024, VSRN's decoder-side
# width, SAEM's rnn heads at its training batch of 64 (H 1024 over BERT's 32
# slots, H 256 over 36 regions) and the ragged H
GRU_BWD_SHAPES = ((8, 48, 1024), (1, 48, 1024), (128, 36, 512), (64, 32, 1024),
                  (64, 36, 256), (37, 21, 1036))
# (B, L, H) the bf16 W_hh adjoint (train_bf16) is held and timed at: SCAN's
# training call (48 words, H 1024) and VSRN's two H 2048 call sites (the text
# GRU over 61 slots, the region GRU over 36 regions)
GRU_BF16_BWD_SHAPES = ((128, 48, 1024), (128, 61, 2048), (128, 36, 2048))
# the bf16 adjoint against gru_bwd_plain(dot_dtype=bf16) on the bf16
# forward kernel's residuals, max|kernel - plain| / max|plain| per output.
# Both round g_gh to bf16 before the product and write ggx and ghn as bf16
# values, so an entry whose fp32 value the two sides sum in another order
# may round one bf16 step apart: up to 2^-7 of the largest entry; what
# holds their rounding points is the share of entries that differ at all
# (GRU_BF16_UNEQUAL: read at most 0.024 on the H100 at these shapes, on
# BF16_MODES_SEED's inputs and on another draw; the plain adjoint without
# the roundings, its output alone rounded, at least 0.064).  g_h0 is fp32
# and held in the fp32 order's kind: read at most 2.2e-4, the plain adjoint
# without the roundings (fp32 g_gh and W_hh) at least 4.7e-4.  Each reading
# must pass its limit, and the plain adjoint without the roundings must
# fail it
GRU_BF16_BWD_REL = {"ggx": 2.0 ** -7, "ghn": 2.0 ** -7, "g_h0": 3.3e-4}
GRU_BF16_UNEQUAL = 0.04
# the seed of the generator that draws the bf16 modes' inputs, first the
# adjoint's, then the decoder's
BF16_MODES_SEED = 25
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
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
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
    for mode in MODE_OF.values():
        COUNTERS[mode].bf16_launches = 0


def read_counters() -> dict:
    """Each kernel's launches, and those of each bf16 mode (MODE_OF) on
    their own."""
    return {**{name: fn.launches for name, fn in COUNTERS.items()},
            **{name: COUNTERS[mode].bf16_launches for name, mode in MODE_OF.items()}}


def check_modes(launches: dict, bf16: bool, what: str) -> None:
    """A train_bf16 path launches the GRU adjoint and the decoder pair in
    their bf16 modes only; an fp32 path never in them."""
    for name, mode in MODE_OF.items():
        fp32 = launches[mode] - launches[name]
        if (fp32 if bf16 else launches[name]):
            raise AssertionError(f"{what}: {mode} launched {fp32} times in its fp32 mode and "
                                 f"{launches[name]} in its bf16 mode")


def phase_build():
    def timed_build(name):
        t0 = time.perf_counter()
        kernels.build(name)
        return time.perf_counter() - t0

    names = [os.path.splitext(src)[0] for src in SOURCES.values()]
    with ThreadPoolExecutor(len(names) + len(SAF_VARIANTS)) as ex:
        variants = [ex.submit(kernels.build, "sgraf_eval_saf", d) for d in SAF_VARIANTS]
        seconds = dict(zip(names, ex.map(timed_build, names)))
        for v in variants:
            v.result()
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
    if b > 1:
        lengths[0], lengths[1] = 1, l
    else:
        lengths[0] = l
    mask = (torch.arange(l)[None] < lengths[:, None]).float()
    return [t.to(DEV) for t in [x, mask] + w]


def gru_route(b: int, h: int, dtype, backward: bool = False) -> str:
    """The plan the GRU wrapper takes for (B, H, dtype) on this card, as
    printed beside each shape."""
    p = kgru.plan(b, h, dtype, backward=backward, sms=kgru._sms(DEV))
    return (f"route {p.route}, {p.blocks} blocks x {p.units} units, cluster 1, "
            f"{p.smem} B shared, {len(p.chunks)} launch(es)")


def gru_fwd_bound(x, mask, w_ih, w_hh, b_ih, b_hh, out_bytes: int, peak: str) -> dict:
    """Inputs and weights read once, outputs and the final state written once
    (out_bytes an element), over the valid steps only: the input projection
    and the recurrent product (2 n_valid (D + H) 3H) at the peak of their
    operands' type (bf16 mode: the kernel rounds the carry to bf16)."""
    b, l, d = x.shape
    h = w_hh.shape[1]
    ops = 2 * float(mask.sum()) * (d + h) * 3 * h
    return bound(nbytes(x, mask, w_ih, w_hh, b_ih, b_hh) + out_bytes * (b * l * h + b * h),
                 {peak: ops})


def gru_bwd_bound(gates_x, mask, hall, ghall, g_out, g_fin, w_hh, peak: str = "fp32") -> dict:
    """The adjoint alone: gates_x, mask, the residuals, both cotangents and
    W_hh read once, the gate gradients and the initial state's written once;
    (B, 3H) x (3H, H) per valid step at the peak of its operands' type (fp32
    FMAs in the fp32 mode; bf16 with bf16 W_hh, whose mode rounds g_gh).
    In the bf16 mode gates_x and ghall enter, and ggx and ghn leave, as bf16
    values, so they count 2 bytes an element, whatever type holds them."""
    b, _, h = hall.shape
    gate = 2 if w_hh.dtype == torch.bfloat16 else 4
    return bound(nbytes(mask, hall, g_out, g_fin, w_hh) + 4 * b * h
                 + gate * (3 * gates_x.numel() + hall.numel()),  # gates_x, ghall, ggx; ghn
                 {peak: 2 * float(mask.sum()) * 3 * h * h})


def check_co_resident_refusal(g) -> None:
    """A cooperative grid that cannot be co-resident (one block an SM more
    than the card holds) makes the launch fail, and the wrapper raises
    without counting a launch."""
    x, mask, w_ih, w_hh, b_ih, b_hh = _gru_inputs(g, 128, 4, 300, 1024)
    gates_x = (x @ w_ih.t() + b_ih).contiguous()
    sms = kgru._sms(DEV)
    too_many = kgru.Plan(units=8, blocks=sms + 1, route="resident", smem=200_000,
                         chunks=((0, 128),), k_padded=1024)
    before = gru_scan_fused.launches
    try:
        kgru._launch(gates_x, mask, w_hh, b_hh, False, False, too_many)
    except RuntimeError as e:
        if gru_scan_fused.launches != before:
            raise AssertionError("a refused GRU launch was counted") from e
        log(f"  a grid of {sms + 1} blocks of 200000 B on {sms} SMs raises: {e}")
        return
    raise AssertionError("a GRU grid that cannot be co-resident launched")


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
    # both products take bf16 operands in bf16 mode, fp32 in fp32 mode
    res.update(gru_fwd_bound(xb, mask, wib, whb, bib, bhb, 2, "bf16"))
    b32 = gru_fwd_bound(x, mask, w_ih, w_hh, b_ih, b_hh, 4, "fp32")
    res["bound_ms_fp32"], res["bound_by_fp32"] = b32["bound_ms"], b32["bound_by"]
    log(f"  time bf16 (B=128, L=24, H=1024, one direction): kernel {res['ms']:.3f} ms "
        f"(per-step kernel {GRU_PER_STEP_FWD_MS[0]}), plain {res['plain_ms']:.3f} ms, cuDNN "
        f"{res['library_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); fp32: "
        f"kernel {res['ms_fp32']:.3f} ms (per-step kernel {GRU_PER_STEP_FWD_MS[1]}), plain "
        f"{res['plain_ms_fp32']:.3f} ms, cuDNN (TF32 off) {res['library_ms_fp32']:.3f} ms, "
        f"bound {res['bound_ms_fp32']:.4f} ms ({res['bound_by_fp32']})")
    # the shape grid draws from generators of its own, so the later phases'
    # inputs are those of the script without it
    res["shapes"] = gru_fwd_shapes(torch.Generator().manual_seed(1))
    check_co_resident_refusal(torch.Generator().manual_seed(2))
    return res


def gru_fwd_shapes(g) -> list:
    """The forward kernel at every shape of GRU_FWD_SHAPES, bf16 and fp32,
    both directions, held to gru_scan with the carry rounded as the kernel
    rounds it; each (shape, mode) printed with its plan and timed (one
    direction, input projection included, in the mode's dtypes as the main
    paths call it) beside its recurrence alone a step, cuDNN and its
    bound."""
    rows = []
    for b, l, d, h in GRU_FWD_SHAPES:
        x, mask, w_ih, w_hh, b_ih, b_hh = _gru_inputs(g, b, l, d, h)
        for mode, dt, atol in (("bf16", torch.bfloat16, GRU_BF16_ATOL),
                               ("fp32", torch.float32, GRU_FP32_ATOL)):
            w_k = w_hh.to(dt)
            errs = []
            for reverse in (False, True):
                got = gru_scan_fused(x, mask, w_ih, w_k, b_ih, b_hh, reverse=reverse)
                want = gru_scan(x, mask, w_ih, w_k, b_ih, b_hh, reverse=reverse, dot_dtype=dt)
                tag = f"gru B={b} L={l} D={d} H={h} {mode} {'reverse' if reverse else 'forward'}"
                errs += [check(f"{tag} outputs", got[0], want[0], atol),
                         check(f"{tag} final", got[1], want[1], atol)]
            xs, wis, whs, bis, bhs = (t.to(dt) for t in (x, w_ih, w_hh, b_ih, b_hh))
            gates_x = (xs @ wis.t() + bis).float().contiguous()
            ms = cuda_ms(lambda: gru_scan_fused(xs, mask, wis, whs, bis, bhs))
            rec_ms = cuda_ms(lambda: kgru._launch(gates_x, mask, whs, bhs.float(), False, False))
            with torch.no_grad():
                lib = cudnn_gru(w_ih, w_hh, b_ih, b_hh, dt)
                lib_ms = cuda_ms(lambda: lib(xs))
            bd = gru_fwd_bound(xs, mask, wis, whs, bis, bhs, xs.element_size(),
                               "bf16" if dt == torch.bfloat16 else "fp32")
            row = {"b": b, "l": l, "d": d, "h": h, "mode": mode, "route": gru_route(b, h, dt),
                   "max_abs_err": max(errs), "ms": ms, "recurrence_ms": rec_ms,
                   "us_a_step": rec_ms / l * 1e3, "library_ms": lib_ms, **bd}
            log(f"  gru B={b} L={l} D={d} H={h} {mode}: {row['route']}; {ms:.3f} ms with the "
                f"projection, recurrence {rec_ms:.3f} ms = {row['us_a_step']:.2f} us a step; "
                f"cuDNN {lib_ms:.3f} ms; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
            rows.append(row)
    return rows


def phase_gru_bwd(g, b=128, l=48, d=300, h=1024, timed: bool = True,
                  shapes: tuple = ()) -> dict:
    """The GRU adjoint kernel (and the forward's residual mode) against the
    plain versions, at the training path's widths: B=128, L=48 (the caption
    length of scripts/train_bench.py), D=300, H=1024, fp32, ragged lengths
    1..48, both directions, two calls bit-identical; then the adjoint alone
    at each (B, L, H) of `shapes`; with `timed`, then the times, cuDNN's and
    the bound."""
    log(f"GRU adjoint kernel vs plain (B={b}, L={l}, D={d}, H={h}, fp32, ragged 1..{l}; "
        f"{gru_route(b, h, torch.float32, backward=True)})")
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
        check_bit_identical(f"gru_bwd {tag}", kb, gru_bwd_fused(
            gates_x, mask, hall, ghall, g_out, g_fin, w_hh, reverse))
        # both cotangents absent: zero gradients
        z = gru_bwd_fused(gates_x, mask, hall, ghall, None, None, w_hh, reverse)
        if any(float(t.abs().max()) != 0.0 for t in z):
            raise AssertionError("gru_bwd with no cotangent gave non-zero gradients")
    g_shapes = torch.Generator().manual_seed(3)
    res["shapes"] = [gru_bwd_shape(g_shapes, *shape) for shape in shapes]
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
    res.update(gru_bwd_bound(gates_x, mask, hall, ghall, g_out, g_fin, w_hh))
    res["us_a_step"] = res["ms"] / l * 1e3
    then = (f" (per-step kernels {GRU_PER_STEP_BWD_MS[0]})",
            f" (per-step kernels {GRU_PER_STEP_BWD_MS[1]})") if (b, l, h) == (
        128, 48, 1024) else ("", "")
    log(f"  time (one direction, B={b}, L={l}, H={h}, fp32): adjoint kernel "
        f"{res['ms']:.3f} ms{then[0]} = {res['us_a_step']:.2f} us a step, plain "
        f"{res['plain_ms']:.3f} ms; forward kernel with "
        f"residuals {res['fwd_residuals_ms']:.3f} ms, without {res['fwd_ms']:.3f} ms, "
        f"plain {res['fwd_plain_ms']:.3f} ms; forward+backward through autograd "
        f"(input projection included): kernels {res['fwd_bwd_ms']:.3f} ms{then[1]}, plain "
        f"{res['fwd_bwd_plain_ms']:.3f} ms, cuDNN {res['library_ms']:.3f} ms; adjoint "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def phase_gru_bwd_bf16(g) -> dict:
    """The GRU adjoint's bf16 W_hh mode (train_bf16) at GRU_BF16_BWD_SHAPES,
    both directions, against gru_bwd_plain(..., dot_dtype=bf16) on the
    residuals of the bf16 forward kernel (itself held to gru_fwd_plain at
    bf16 dot), two calls bit-identical, a dropped timestep's gradient
    beside each reading; each shape's plan (resident at H 1024 and 2048)
    and time beside the fp32 adjoint's; at SCAN's shape the forward +
    backward through autograd beside cuDNN's bf16 GRU."""
    log("GRU adjoint, bf16 W_hh mode, vs gru_bwd_plain at bf16 dot")
    bf = torch.bfloat16
    res = {"shapes": []}
    for b, l, h in GRU_BF16_BWD_SHAPES:
        x, mask, w_ih, w_hh, b_ih, b_hh = _gru_inputs(g, b, l, 300, h)
        w16 = w_hh.to(bf)
        g_out = torch.randn(b, l, h, generator=g).to(DEV)
        g_fin = torch.randn(b, h, generator=g).to(DEV)
        gates_x = (x @ w_ih.t() + b_ih).contiguous()
        route = gru_route(b, h, bf, backward=True)
        if kgru.plan(b, h, bf, backward=True).route != "resident":
            raise AssertionError(f"the bf16 adjoint at H {h} does not stay resident: {route}")
        errs = {}
        for reverse in (False, True):
            tag = f"gru_bwd bf16 B={b} L={l} H={h} {'reverse' if reverse else 'forward'}"
            k_out, _, hall, ghall = kgru._launch(gates_x, mask, w16, b_hh, reverse,
                                                 residuals=True)
            p_out, _, p_hall, p_ghall = gru_fwd_plain(gates_x, mask, w16, b_hh, reverse,
                                                      dot_dtype=bf)
            check(f"{tag}: the bf16 forward's residual ghall", ghall, p_ghall, GRU_BF16_ATOL)
            kb = gru_bwd_fused(gates_x, mask, hall, ghall, g_out, g_fin, w16, reverse)
            pb = gru_bwd_plain(gates_x, mask, hall, ghall, g_out, g_fin, w16, reverse,
                               dot_dtype=bf)
            lost = g_out.clone()
            lost[:, l // 2] = 0.0
            lb = gru_bwd_plain(gates_x, mask, hall, ghall, lost, g_fin, w16, reverse,
                               dot_dtype=bf)
            nb = gru_bwd_plain(gates_x, mask, hall, ghall, g_out, g_fin, w16, reverse)
            for name, a, w_, c_, n_ in zip(("ggx", "ghn", "g_h0"), kb, pb, lb, nb):
                limit = GRU_BF16_BWD_REL[name]
                err = check_rel(f"{tag} {name}", a, w_, limit)
                errs[f"{'reverse' if reverse else 'forward'} {name}"] = err
                wrong = rel_err(c_, w_)
                log(f"    {name}: with timestep {l // 2}'s cotangent dropped: rel_err {wrong:.3e}")
                if name == "g_h0":
                    check_rounding_points(f"{tag} {name}", rel_err(n_, w_), limit)
                    continue
                check_unequal(f"{tag} {name}", a, w_, n_, GRU_BF16_UNEQUAL)
                if not wrong > limit:
                    raise AssertionError(f"the limit {limit} does not separate a lost "
                                         f"timestep ({wrong}) in {name}")
                if (b, l, h) == GRU_BF16_BWD_SHAPES[0] and name == "ggx" and not reverse:
                    res["max_abs_err"] = float((a - w_).abs().max())
            check_bit_identical(tag, kb, gru_bwd_fused(gates_x, mask, hall, ghall, g_out,
                                                       g_fin, w16, reverse))
        _, _, hall, ghall = kgru._launch(gates_x, mask, w16, b_hh, False, residuals=True)
        _, _, hall32, ghall32 = kgru._launch(gates_x, mask, w_hh, b_hh, False, residuals=True)
        row = {"b": b, "l": l, "h": h, "route": route, "max_rel_err": max(errs.values()),
               "ms": cuda_ms(lambda: gru_bwd_fused(gates_x, mask, hall, ghall, g_out, g_fin,
                                                   w16)),
               "fp32_ms": cuda_ms(lambda: gru_bwd_fused(gates_x, mask, hall32, ghall32, g_out,
                                                        g_fin, w_hh)),
               **gru_bwd_bound(gates_x, mask, hall, ghall, g_out, g_fin, w16, peak="bf16")}
        log(f"  gru_bwd bf16 B={b} L={l} H={h}: {route}; {row['ms']:.3f} ms = "
            f"{row['ms'] / l * 1e3:.2f} us a step (fp32 adjoint {row['fp32_ms']:.3f} ms); "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, bf16 peak)")
        res["shapes"].append(row)
        if (b, l, h) != GRU_BF16_BWD_SHAPES[0]:
            continue
        res.update(ms=row["ms"], fp32_ms=row["fp32_ms"], bound_ms=row["bound_ms"],
                   bound_by=row["bound_by"], rel_err=errs)
        res["plain_ms"] = cuda_ms(lambda: gru_bwd_plain(gates_x, mask, hall, ghall, g_out,
                                                        g_fin, w16, dot_dtype=bf), reps=5)
        ps = [t.detach().clone().requires_grad_() for t in (x, w_ih, w16, b_ih, b_hh)]

        def fwd_bwd():
            o, fin = gru_scan_fused(ps[0], mask, *ps[1:])
            return torch.autograd.grad((o * g_out).sum() + (fin * g_fin).sum(), ps)

        res["fwd_bwd_ms"] = cuda_ms(fwd_bwd, reps=10)
        # the library yardstick: cuDNN's bf16 GRU forward + backward under
        # autograd on the same padded batch (bf16 input and weights)
        lib = cudnn_gru(w_ih, w_hh, b_ih, b_hh, bf)
        xg = x.detach().to(bf).requires_grad_()
        g_out16, g_fin16 = g_out.to(bf), g_fin.to(bf)

        def lib_fwd_bwd():
            o, fin = lib(xg)
            return torch.autograd.grad((o * g_out16).sum() + (fin[0] * g_fin16).sum(),
                                       [xg, *lib.parameters()])

        res["library_ms"] = cuda_ms(lib_fwd_bwd, reps=10)
        res["library_call"] = ("torch.nn.GRU (cuDNN) bf16 forward + backward under autograd, "
                               "beside the kernels' bf16 forward + backward (fwd_bwd_ms)")
        log(f"  time (B={b}, L={l}, H={h}, bf16 W_hh): adjoint kernel {res['ms']:.3f} ms (fp32 "
            f"mode {res['fp32_ms']:.3f}), plain {res['plain_ms']:.3f} ms; forward + backward "
            f"through autograd: kernels {res['fwd_bwd_ms']:.3f} ms, cuDNN bf16 "
            f"{res['library_ms']:.3f} ms; bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def check_bit_identical(tag: str, first, second) -> None:
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{tag}: two calls on the same inputs differ")
    log(f"  {tag}: two calls bit-identical")


def gru_bwd_shape(g, b: int, l: int, h: int) -> dict:
    """The adjoint alone at (B, L, H), both directions, against
    gru_bwd_plain on the forward kernel's residuals (GRU_BWD_REL), two calls
    bit-identical; timed in the reverse direction beside its bound."""
    x, mask, w_ih, w_hh, b_ih, b_hh = _gru_inputs(g, b, l, 300, h)
    g_out = torch.randn(b, l, h, generator=g).to(DEV)
    g_fin = torch.randn(b, h, generator=g).to(DEV)
    gates_x = (x @ w_ih.t() + b_ih).contiguous()
    route = gru_route(b, h, torch.float32, backward=True)
    errs = []
    for reverse in (False, True):
        tag = f"gru_bwd B={b} L={l} H={h} {'reverse' if reverse else 'forward'}"
        _, _, hall, ghall = kgru._launch(gates_x, mask, w_hh, b_hh, reverse, residuals=True)
        kb = gru_bwd_fused(gates_x, mask, hall, ghall, g_out, g_fin, w_hh, reverse)
        pb = gru_bwd_plain(gates_x, mask, hall, ghall, g_out, g_fin, w_hh, reverse)
        errs += [check_rel(f"{tag} {name}", a, w, GRU_BWD_REL)
                 for name, a, w in zip(("ggx", "ghn", "g_h0"), kb, pb)]
        check_bit_identical(tag, kb, gru_bwd_fused(gates_x, mask, hall, ghall, g_out, g_fin,
                                                   w_hh, reverse))
    ms = cuda_ms(lambda: gru_bwd_fused(gates_x, mask, hall, ghall, g_out, g_fin, w_hh, True))
    bd = gru_bwd_bound(gates_x, mask, hall, ghall, g_out, g_fin, w_hh)
    log(f"  gru_bwd B={b} L={l} H={h}: {route}; {ms:.3f} ms = {ms / l * 1e3:.2f} us a step; "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"b": b, "l": l, "h": h, "route": route, "max_rel_err": max(errs), "ms": ms,
            "us_a_step": ms / l * 1e3, **bd}


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
    cores for bf16 inputs; for fp32 inputs at the TF32 tensor-core peak, as
    the SGRAF and VSRN bounds count fp32 products, the
    operations counted once; the kernel itself runs them on the fp64 tensor
    cores, 67 TFLOP/s) and the chain after it by fp32 FMAs (t2i: the 36 x 36
    region Gram per word; i2t: the L x L word Gram per region, plus some ten
    operations per (region, word) either way).  `bound_ms_fp32_peak`: the
    fp32 bound with A at the fp32 FMA peak, as the earlier design stated it."""
    ni, r, d = img.shape
    lengths = mask.sum(dim=1).double()
    a_ops = 2.0 * ni * r * d * float(lengths.sum())
    if direction == "t2i":
        chain = ni * float(lengths.sum()) * (2 * r * r + 10 * r)
    else:
        chain = ni * r * float((2 * lengths ** 2 + 10 * lengths).sum())
    n_bytes = nbytes(img, cap, mask) + 4 * ni * cap.shape[0]
    if img.dtype == torch.bfloat16:
        return bound(n_bytes, {"bf16": a_ops, "fp32": chain})
    res = bound(n_bytes, {"tf32": a_ops, "fp32": chain})
    res["bound_ms_fp32_peak"] = bound(n_bytes, {"fp32": a_ops + chain})["bound_ms"]
    return res


# the SCAN kernels' earlier design (wmma / fp32 FMA A product, two
# images a block), PERF.md section 6: (bf16, fp32) ms at 64 x 320 x 36 x 24
XATTN_FMA_MS = {"xattn": (0.605, 3.805), "xattn_i2t": (0.872, 4.384)}
# the checked shapes (Ni, Nc, L): the timed one; Ni not a multiple of the
# tile's 6 or 4 images; L 128 (one caption a tile); L not a multiple of 8
# (padded by the wrapper); two words (padded to 8).  Each phase draws the
# shapes the earlier design's phase checked from the script's generator, in
# their old order (so that every later phase sees the draws it saw before),
# the others from its own.
XATTN_SHAPES = ((64, 320, 24), (37, 211, 24), (5, 7, 128), (13, 50, 21), (7, 9, 2))
XATTN_OLD_SHAPES = {"xattn": XATTN_SHAPES[:2], "xattn_i2t": XATTN_SHAPES[:3]}


def median_ms(fn, runs: int = 5) -> tuple:
    """(median, min, max) of `runs` cuda_ms readings of fn."""
    t = sorted(cuda_ms(fn) for _ in range(runs))
    return t[len(t) // 2], t[0], t[-1]


def cublas_a_ms(img, cap) -> float:
    """The A product alone as one cuBLAS call, (Ni 36, D) x (D, Nc L): a
    yardstick for the kernels' product part (no PyTorch call computes the
    grid; the port never calls this)."""
    a, b = img.reshape(-1, img.shape[-1]), cap.reshape(-1, cap.shape[-1]).t()
    return median_ms(lambda: torch.matmul(a, b))[0]


def _xattn_phase(g, name: str, fused, plain, kws: dict, timed_agg: str) -> dict:
    """Both aggregations at every XATTN_SHAPES shape, bf16 and fp32, against
    the plain version on the same values (XATTN_BF16_ATOL, XATTN_FP32_ATOL);
    two calls bit-identical; then timed at 64 x 320 x 36 x 24 x 1024 in
    `timed_agg` (medians of 5 readings, with their spread) beside the plain
    version, the earlier design, cuBLAS's A product and the bound."""
    own = torch.Generator().manual_seed(21)
    res = {}
    for ni, nc, l in XATTN_SHAPES:
        img, cap, mask = _xattn_inputs(g if (ni, nc, l) in XATTN_OLD_SHAPES[name] else own,
                                       ni, nc, l)
        img16, cap16 = img.to(torch.bfloat16), cap.to(torch.bfloat16)
        for agg, k in kws.items():
            tag = f"{name} {ni}x{nc}x36x{l} {agg}"
            e16 = check(f"{tag} bf16", fused(img16, cap16, mask, **k),
                        plain(img16.float(), cap16.float(), mask, **k), XATTN_BF16_ATOL)
            check(f"{tag} fp32", fused(img, cap, mask, **k), plain(img, cap, mask, **k),
                  XATTN_FP32_ATOL)
            if (ni, agg) == (64, timed_agg):
                res["max_abs_err"] = e16
    img, cap, mask = _xattn_inputs(g, 64, 320, 24)
    img16, cap16 = img.to(torch.bfloat16), cap.to(torch.bfloat16)
    k = kws[timed_agg]
    for x, c in ((img16, cap16), (img, cap)):
        check_bit_identical(f"{name} 64x320x36x24 {str(x.dtype)[6:]}", [fused(x, c, mask, **k)],
                            [fused(x, c, mask, **k)])
    ms16, ms32 = median_ms(lambda: fused(img16, cap16, mask, **k)), median_ms(
        lambda: fused(img, cap, mask, **k))
    res["ms"], res["ms_spread"], res["ms_fp32"], res["ms_fp32_spread"] = (
        ms16[0], ms16[1:], ms32[0], ms32[1:])
    res["plain_ms"] = cuda_ms(lambda: plain(img16, cap16, mask, **k))
    res["plain_ms_fp32"] = cuda_ms(lambda: plain(img, cap, mask, **k))
    res["cublas_a_ms"], res["cublas_a_ms_fp32"] = cublas_a_ms(img16, cap16), cublas_a_ms(img, cap)
    res.update(xattn_bound(img16, cap16, mask, "t2i" if name == "xattn" else "i2t"))
    b32 = xattn_bound(img, cap, mask, "t2i" if name == "xattn" else "i2t")
    res["bound_ms_fp32"], res["bound_ms_fp32_peak"] = b32["bound_ms"], b32["bound_ms_fp32_peak"]
    # no single PyTorch call computes the stacked cross-attention score grid
    res["library_ms"] = None
    was16, was32 = XATTN_FMA_MS[name]
    log(f"  time 64x320x36x24x1024 {timed_agg} bf16: kernel {ms16[0]:.4f} ms "
        f"({ms16[1]:.4f}-{ms16[2]:.4f}; earlier design {was16:.3f}), plain {res['plain_ms']:.3f} ms, "
        f"cuBLAS A alone {res['cublas_a_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), {100 * res['bound_ms'] / ms16[0]:.1f}% of it")
    log(f"  fp32: kernel {ms32[0]:.4f} ms ({ms32[1]:.4f}-{ms32[2]:.4f}; earlier design {was32:.3f}), "
        f"plain {res['plain_ms_fp32']:.3f} ms, cuBLAS A alone {res['cublas_a_ms_fp32']:.4f} ms, "
        f"bound {b32['bound_ms']:.4f} ms at the TF32 peak ({b32['bound_by']}), "
        f"{100 * b32['bound_ms'] / ms32[0]:.1f}% of it; {b32['bound_ms_fp32_peak']:.4f} ms "
        f"at the fp32 peak")
    return res


def phase_xattn(g) -> dict:
    log("xattn t2i kernel vs plain (clipped_l2norm; R=36, D=1024)")
    kws = {"LogSumExp": dict(agg_func="LogSumExp"), "Mean": dict(agg_func="Mean")}
    return _xattn_phase(g, "xattn", xattn_t2i_fused, xattn_t2i_plain, kws, "LogSumExp")


def phase_xattn_i2t(g) -> dict:
    log(f"xattn i2t kernel vs plain (clipped_l2norm; R=36, D=1024, lambda_softmax "
        f"{I2T_SOFTMAX:g}, LogSumExp at lambda_lse {I2T_LSE:g})")
    kws = {"LogSumExp": dict(agg_func="LogSumExp", lambda_lse=I2T_LSE,
                             lambda_softmax=I2T_SOFTMAX),
           "Mean": dict(agg_func="Mean", lambda_softmax=I2T_SOFTMAX)}
    # the main path's mode: i-t AVG, bf16
    return _xattn_phase(g, "xattn_i2t", xattn_i2t_fused, xattn_i2t_plain, kws, "Mean")


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
    embeddings, else at the TF32 tensor-core peak: the least time the card
    could take for them), and the rest of the chain by fp32 operations: per
    valid word the 36 x 36 Gram form, the region softmax, the squared
    difference (3 D) and the node's norm, gate and pooling (6 S); per pair
    the global difference (3 D) and the same node work.  Also
    "product_flop", the products' operations."""
    ni, r, d = img.shape
    nc = cap.shape[0]
    n_words = float(mask.sum())
    products = 2.0 * ni * n_words * (2 * r * d + d * s) + 2.0 * ni * nc * d * s
    rest = ni * n_words * (2 * r * r + 10 * r + 3 * d + 6 * s) + ni * nc * (3 * d + 6 * s)
    peak = "bf16" if img.dtype == torch.bfloat16 else "tf32"
    n_bytes = nbytes(img, cap, mask) + (ni + nc) * d * img.element_size() \
        + 4 * (2 * s * d + 4 * s + 2) + 4 * ni * nc
    return {**bound(n_bytes, {peak: products, "fp32": rest}), "product_flop": products}


def _sgraf_eval_times(name: str, fused, plain, x: dict, x16: dict, bound_fn) -> dict:
    """Kernel and plain ms at one shape, bf16 and fp32 embeddings, beside the
    bound of each; the effective rate of the products (their operations over
    the kernel's time) and the share of the bound; two more launches of each
    mode bit-identical to the first."""
    res = {}
    for tag, inp in (("", x16), ("_fp32", x)):
        first = fused(**inp)
        for _ in range(2):
            check_bit_identical(f"{name}{tag or '_bf16'} repeat", (first,), (fused(**inp),))
        res["ms" + tag] = cuda_ms(lambda: fused(**inp), reps=10)
        res["plain_ms" + tag] = cuda_ms(lambda: plain(**inp), reps=10)
        b = bound_fn(inp["img"], inp["cap"], inp["mask"])
        res["bound_ms" + tag], res["bound_by" + tag] = b["bound_ms"], b["bound_by"]
        res["tflops" + tag] = b["product_flop"] / (res["ms" + tag] * 1e9)
        res["share_of_bound" + tag] = b["bound_ms"] / res["ms" + tag]
    before = SGRAF_EVAL_FMA_MS[name]
    log(f"  time 64x320x36x24x1024, S 256: bf16 kernel {res['ms']:.3f} ms (the FMA design: "
        f"{before[0]:.3f}), plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), products {res['tflops']:.2f} TFLOP/s, "
        f"{100 * res['share_of_bound']:.2f}% of the bound; fp32 kernel {res['ms_fp32']:.3f} ms "
        f"({before[1]:.3f}), plain {res['plain_ms_fp32']:.3f} ms, bound "
        f"{res['bound_ms_fp32']:.4f} ms ({res['bound_by_fp32']}), products "
        f"{res['tflops_fp32']:.2f} TFLOP/s, {100 * res['share_of_bound_fp32']:.2f}% of the bound")
    return res


def _saf_variant_ms(defines: tuple, inp: dict) -> float:
    """ms of a measurement build of the SAF kernel (built in phase_build) on
    the wrapper's inputs."""
    lib = kernels.load("sgraf_eval_saf", defines)
    return cuda_ms(lambda: ksgraf_eval.launch_saf(lib, **inp), reps=10)


def phase_sgraf_eval_saf(g) -> dict:
    log("sgraf_eval_saf kernel vs plain (R=36, D=1024, S=256, lambda 9)")
    res = {}
    # the main width, then ragged shapes: a single-word caption, L not a
    # multiple of 8, odd caption and image counts; L 4 (the block's cap of
    # 16 captions applies); a caption as long as the kernel takes; sim_dim
    # 128 (one warpgroup's columns)
    for ni, nc, l, s in ((64, 320, 24, 256), (37, 211, 21, 256), (9, 70, 4, 256),
                         (5, 7, 128, 256), (9, 13, 16, 128)):
        x = _saf_inputs(g, ni, nc, l, s=s)
        x16 = _saf_cast(x, torch.bfloat16)
        got = sgraf_eval_saf_fused(**x16)
        want = sgraf_eval_saf_plain(**_saf_cast(x16, torch.float32))
        e16 = check(f"sgraf_eval_saf {ni}x{nc}x36x{l} S {s} bf16", got, want, SAF_BF16_ATOL)
        check(f"sgraf_eval_saf {ni}x{nc}x36x{l} S {s} fp32", sgraf_eval_saf_fused(**x),
              sgraf_eval_saf_plain(**x), SAF_FP32_ATOL)
        if ni == 64:
            res["max_abs_err"] = e16
            spread = float(want.std(dim=1).mean())
            log(f"  mean per-caption std of the scores over images: {spread:.3e}")
    x = _saf_inputs(g, 64, 320, 24)
    x16 = _saf_cast(x, torch.bfloat16)
    res.update(_sgraf_eval_times("saf", sgraf_eval_saf_fused, sgraf_eval_saf_plain, x, x16,
                                 saf_bound))
    # where the time goes: the same inputs with the tile epilogues (norms,
    # gates, pooling) cut, then with the projection cut too (the assembly)
    no_pool = _saf_variant_ms(SAF_NO_POOL, x16)
    assembly = _saf_variant_ms(SAF_NO_PROJECT, x16)
    res["ms_phases"] = {"assembly": assembly, "projection": no_pool - assembly,
                        "pooling_and_epilogue": res["ms"] - no_pool}
    # no single PyTorch call computes the SGRAF-SAF score grid
    res["library_ms"] = None
    log("  kernel bf16 by phase: " + ", ".join(f"{k} {v:.3f} ms"
                                               for k, v in res["ms_phases"].items()))
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
    embeddings, else at the TF32 tensor-core peak; the rest of the chain by
    fp32 operations: per valid word the 36 x 36 Gram form, the region
    softmax, the squared difference (3 D) and the node's bias and norm (3 S),
    per pair the global difference (3 D) and its node's (3 S).  Also
    "product_flop", the products' operations."""
    ni, r, d = img.shape
    nc = cap.shape[0]
    words = mask.sum(dim=1).double()
    n_words = float(words.sum())
    n = words + 1
    align = 2.0 * ni * n_words * (2 * r * d + d * s) + 2.0 * ni * nc * d * s
    reason = ni * float(((steps - 1) * (4 * n * s * s + 4 * n * n * s)
                         + 4 * s * s + 4 * n * s).sum())
    rest = ni * n_words * (2 * r * r + 10 * r + 3 * d + 3 * s) + ni * nc * (3 * d + 3 * s)
    peak = "bf16" if img.dtype == torch.bfloat16 else "tf32"
    n_bytes = nbytes(img, cap, mask) + (ni + nc) * d * img.element_size() \
        + 4 * (2 * s * d + 2 * s + steps * (3 * s * s + 3 * s) + s + 1) + 4 * ni * nc
    return {**bound(n_bytes, {peak: align + reason, "fp32": rest}),
            "product_flop": align + reason}


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
    res.update(_sgraf_eval_times("sgr", sgraf_eval_sgr_fused, sgraf_eval_sgr_plain, x, x16,
                                 sgr_bound))
    # where the kernel's time goes: the same inputs at 1 and 2 steps (the
    # node-0 step alone, then one full step more)
    res["ms_by_steps"] = {
        k: cuda_ms(lambda k=k: sgraf_eval_sgr_fused(
            **{n: v[-k:] if n in SGR_STEP_WEIGHTS else v for n, v in x16.items()}),
            reps=10)
        for k in (1, 2)}
    res["ms_by_steps"][3] = res["ms"]
    # no single PyTorch call computes the SGRAF-SGR score grid
    res["library_ms"] = None
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
    projection (D x S), and some 4 D + 50 R + 4 S fp32 operations of the
    chain.  Backward: the same inputs and the cotangent read once, gcap and
    gimg (in cap's dtype) and the fp32 dW, db written once; the recomputed
    products, W gy and dW (D x S each) and four more 36 x D products, and
    about twice the forward's chain.  Both run their products on the tensor
    cores in both modes, so they count at the bf16 tensor-core peak for bf16
    embeddings and at the TF32 peak for fp32, as the eval kernels' do.  Also
    "product_flop", the products' operations."""
    ni, r, d = img.shape
    nc, l, _ = cap.shape
    pairs = ni * float(mask.sum())
    es = img.element_size()
    bf16 = img.dtype == torch.bfloat16
    if backward:
        products = 2.0 * pairs * (6 * r * d + 3 * d * s)
        rest = 2.0 * pairs * (4 * d + 50 * r + 4 * s)
        n_bytes = nbytes(img, cap, mask) + 4 * (s * d + s) + nc * ni * l * s * es \
            + (cap.numel() + img.numel()) * es + 4 * (s * d + s)
        ops = {"bf16" if bf16 else "tf32": products, "fp32": rest}
    else:
        products = 2.0 * pairs * (2 * r * d + d * s)
        rest = pairs * (4 * d + 50 * r + 4 * s)
        n_bytes = nbytes(img, cap, mask) + 4 * (s * d + s) + nc * ni * l * s * es
        ops = {"bf16" if bf16 else "tf32": products, "fp32": rest}
    return {**bound(n_bytes, ops), "product_flop": products}


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
            # the output's memory held NaN before: the kernel writes every
            # row, the masked words' zero rows too (the caching allocator
            # hands the freed block to the wrapper's first allocation)
            junk = torch.full((nc, ni, l, x["w"].shape[0]), float("nan"), dtype=dt, device=DEV)
            junk_ptr = junk.data_ptr()
            del junk
            with torch.no_grad():
                got = sgraf_align_fused(**xd)
                again = sgraf_align_fused(**xd)
            want = sgraf_align_plain(**xd)
            e_fwd = check(f"{tag} forward", got, want,
                          ALIGN_BF16_ATOL if dt == torch.bfloat16 else ALIGN_FP32_ATOL)
            masked = got.permute(0, 2, 1, 3)[x["mask"] <= 0]
            zero = bool((masked == 0).all())
            same_fwd = torch.equal(got, again)
            log(f"  {tag}: forward over NaN-filled memory (same block: "
                f"{got.data_ptr() == junk_ptr}): {masked.shape[0]} masked rows exactly zero: "
                f"{zero}; two forward calls bit-identical: {same_fwd}")
            if not zero:
                raise AssertionError(f"{tag}: the forward left masked words nonzero")
            if not same_fwd:
                raise AssertionError(f"{tag}: the forward is not deterministic")
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
            if dt == torch.bfloat16:
                # the float64 witness: the kernel's and the plain version's bf16
                # gcap and gimg, each against a float64 plain run on the same
                # (bf16) values, which separates the kernel's error from the
                # conditioning of the one-word captions' sign-like word norm
                x64 = {k: v.double() for k, v in xd.items()}
                p64 = sgraf_align_bwd_plain(**x64, g=cot.to(dt).double())
                wit = {}
                for i, name in ((0, "gcap"), (1, "gimg")):
                    wit[name] = {"kernel": rel_err(kb[i].double(), p64[i]),
                                 "plain": rel_err(pb[i].double(), p64[i])}
                    log(f"    float64 witness {name}: kernel {wit[name]['kernel']:.3e}, plain "
                        f"{wit[name]['plain']:.3e} of the float64 plain run (the kernel vs "
                        f"the plain version: {errs[name]:.3e}; limit "
                        f"{ALIGN_BWD_BF16_REL:g})")
                res.setdefault("bwd_f64_witness", {})[f"{nc}x{ni}x{l}"] = wit
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
            res["launch_ms" + suf] = _launch_ms(lambda: sgraf_align_fused(**xd))
            res["plain_ms" + suf] = cuda_ms(lambda: sgraf_align_plain(**xd), reps=5)
        res["bwd_ms" + suf] = cuda_ms(lambda: sgraf_align_bwd_fused(**xd, g=c_), reps=10)
        res["bwd_launch_ms" + suf] = _launch_ms(lambda: sgraf_align_bwd_fused(**xd, g=c_))
        res["bwd_plain_ms" + suf] = cuda_ms(lambda: sgraf_align_bwd_plain(**xd, g=c_), reps=5)
        fb = align_bound(xd["img"], xd["cap"], xd["mask"])
        bb = align_bound(xd["img"], xd["cap"], xd["mask"], backward=True)
        res["bound_ms" + suf], res["bound_by" + suf] = fb["bound_ms"], fb["bound_by"]
        res["tflops" + suf] = fb["product_flop"] / (res["ms" + suf] * 1e9)
        res["share_of_bound" + suf] = fb["bound_ms"] / res["ms" + suf]
        res["bwd_bound_ms" + suf], res["bwd_bound_by" + suf] = bb["bound_ms"], bb["bound_by"]
        res["bwd_tflops" + suf] = bb["product_flop"] / (res["bwd_ms" + suf] * 1e9)
        res["bwd_share_of_bound" + suf] = bb["bound_ms"] / res["bwd_ms" + suf]
    # neither kernel's wrapper reads anything back to the host: a
    # synchronizing call under the sync debug mode raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            sgraf_align_fused(**xd)
        sgraf_align_bwd_fused(**xd, g=c_)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res["fwd_no_sync"] = res["bwd_no_sync"] = True
    # no single PyTorch call computes the alignment chain or its backward
    res["library_ms"] = None
    log(f"  time 32x128x36x24x1024, S 256, bf16: forward kernel {res['ms']:.3f} ms (the FMA "
        f"design: {ALIGN_FWD_FMA_MS[0]:.3f}), plain {res['plain_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}), products {res['tflops']:.2f} TFLOP/s, "
        f"{100 * res['share_of_bound']:.2f}% of the bound; backward kernels "
        f"{res['bwd_ms']:.3f} ms (the FMA design: {ALIGN_BWD_FMA_MS[0]:.3f}), "
        f"plain {res['bwd_plain_ms']:.3f} ms, bound {res['bwd_bound_ms']:.4f} ms "
        f"({res['bwd_bound_by']}), products {res['bwd_tflops']:.2f} TFLOP/s, "
        f"{100 * res['bwd_share_of_bound']:.2f}% of the bound; fp32: forward "
        f"{res['ms_fp32']:.3f} ms ({ALIGN_FWD_FMA_MS[1]:.3f}; plain {res['plain_ms_fp32']:.3f}, "
        f"bound {res['bound_ms_fp32']:.4f} at the TF32 peak, products "
        f"{res['tflops_fp32']:.2f} TFLOP/s, {100 * res['share_of_bound_fp32']:.2f}%), backward "
        f"{res['bwd_ms_fp32']:.3f} ms "
        f"({ALIGN_BWD_FMA_MS[1]:.3f}; plain {res['bwd_plain_ms_fp32']:.3f}, bound "
        f"{res['bwd_bound_ms_fp32']:.4f} at the TF32 peak, products "
        f"{res['bwd_tflops_fp32']:.2f} TFLOP/s, {100 * res['bwd_share_of_bound_fp32']:.2f}%)")
    for suf, tag in (("", "bf16"), ("_fp32", "fp32")):
        for kind, key in (("forward", "launch_ms"), ("backward", "bwd_launch_ms")):
            log(f"  {kind} {tag}, device ms a call by launch (profiler): " + ", ".join(
                f"{k} {v:.3f}" for k, v in res[key + suf].items()))
    log("  one forward and one backward call under torch.cuda.set_sync_debug_mode('error'): "
        "no sync")
    return res


def _launch_ms(fn, calls: int = 5) -> dict:
    """Device milliseconds a call of each kernel that `fn` launches, from
    torch.profiler over `calls` calls after a warm-up (the kernel's name up
    to its argument list)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0)
        if us > 0:
            key = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = key.split("(")[0].split("<")[0].split("::")[-1].strip() or key[:40]
            out[name] = out.get(name, 0.0) + us / calls / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


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
    """The bounds of one reasoning call.  Per pair over its n valid nodes
    and per step, the forward does the folded q/k product s M and ctx Wg^T
    (4 n S^2) and the edges and contexts (4 n^2 S); the backward recomputes
    s M and the edges and adds g_pre Wg, the two weight sums and g_sm M^T
    (10 n S^2 in all) and g_a, g_sm and the key-side sums (12 n^2 S in
    all).  Bytes: the nodes at their valid rows (no kernel reads a masked
    row), the mask and the steps' weights read once; the forward writes
    every step's fp32 output whole (the masked rows' zeros are part of
    it), the backward reads them and the cotangent at the valid rows and
    writes g_s0 and the weight gradients.  Both run their
    products on the tensor cores as split-bf16 products, so "bound_ms"
    counts them at the TF32 tensor-core peak and the edges at the fp32
    peak; "bound_ms_fp32_peak": all at the fp32 peak (the FMA designs'
    figure), "bound_ms_bf16_peak": all at the bf16 peak (the work as
    `itrx` runs it, bf16 operands on the MXU).  Also "product_flop", the
    S x S products' operations."""
    b, nn_, s = s0.shape
    n = mask.sum(dim=1).double()
    rows = float(n.sum())
    products = steps * float(((10 if backward else 4) * n * s * s).sum())
    edges = steps * float(((12 if backward else 4) * n * n * s).sum())
    weights = 4 * steps * (3 * s * s + 3 * s)
    reads = rows * s * s0.element_size() + nbytes(mask) + weights
    if backward:
        n_bytes = reads + 4 * (steps + 1) * rows * s + s0.numel() * s0.element_size() + weights
    else:
        n_bytes = reads + 4 * steps * b * nn_ * s
    b32 = bound(n_bytes, {"fp32": products + edges})
    b16 = bound(n_bytes, {"bf16": products + edges})
    main = bound(n_bytes, {"tf32": products, "fp32": edges})
    return {"bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_ms_fp32_peak": b32["bound_ms"], "bound_by_fp32_peak": b32["bound_by"],
            "bound_ms_bf16_peak": b16["bound_ms"], "bound_by_bf16_peak": b16["bound_by"],
            "product_flop": products}


@contextlib.contextmanager
def nan_empty():
    """In the block torch.empty fills every floating tensor it makes with
    NaN, so a wrapper's output that its kernels must write whole reads NaN
    wherever they did not; yields the list of those tensors' addresses."""
    real, made = torch.empty, []

    def empty(*args, **kwargs):
        t = real(*args, **kwargs)
        if t.is_floating_point():
            made.append(t.fill_(float("nan")).data_ptr())
        return t

    torch.empty = empty
    try:
        yield made
    finally:
        torch.empty = real


def _sgr_rel(got, want, scale: float) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), SGR_FLOOR * scale)


def phase_sgr(g) -> dict:
    """The training reasoning kernels vs their plain pair: one training
    chunk (4096 pairs, ragged 1-24 words, S 256, sgr_step 3) in fp32 (the
    path's dtype) and bf16, a ragged odd shape and the 129-node limit at
    S 128 and S 256; the final nodes and every step's save (masked rows
    exactly 0 over NaN-filled memory, two forward calls bit-identical), all
    seven cotangents (dbk identically 0) and two backward calls
    bit-identical; then times and bounds at the training chunk."""
    log("sgr reasoning forward + backward kernels vs plain (q/k fold, split-bf16 products)")
    res = {}
    names = ("g_s0", "dWq", "dbq", "dWk", "dbk", "dWg", "dbg")
    for pairs, l, steps, s in SGR_SHAPES:
        x, cot = _sgr_reason_inputs(g, pairs, l, steps, s)
        for dt in (torch.float32, torch.bfloat16):
            tag = (f"sgr {pairs} pairs x {l + 1} nodes, S {s}, sgr_step {steps} "
                   f"{'bf16' if dt == torch.bfloat16 else 'fp32'}")
            xd = dict(x, s0=x["s0"].to(dt))
            # the saves' memory holds NaN before the kernels run: they write
            # every row of every step, the masked rows' zeros too
            with nan_empty() as made:
                got, saves = sgr_reason_fwd_fused(**xd)
            if saves.data_ptr() not in made:
                raise AssertionError(f"{tag}: the saves were not allocated NaN-filled")
            _, again = sgr_reason_fwd_fused(**xd)
            if dt == torch.float32:
                # the forward's list and edge ranges, formed on the card,
                # equal their plain versions
                blocks = edge_blocks(pairs, DEV)
                rows, pstart, bounds = card_plan(x["mask"], blocks)
                want_rows, want_pstart = row_list(x["mask"])
                same_plan = (torch.equal(rows, want_rows) and torch.equal(pstart, want_pstart)
                             and torch.equal(bounds, edge_bounds(want_pstart, blocks)))
                log(f"  {tag}: the plan kernels' row list, pair starts and {blocks} edge ranges "
                    f"equal row_list and edge_bounds: {same_plan}")
                if not same_plan:
                    raise AssertionError(f"{tag}: the plan kernels disagree with row_list / "
                                         "edge_bounds")
            want, outs = sgr_reason_plain(**xd)
            bf16 = dt == torch.bfloat16
            e_fwd = check_rel(f"{tag} forward nodes", got, want,
                              SGR_BF16_REL if bf16 else SGR_FWD_REL)
            e_saves = check_rel(f"{tag} forward saves, every step", saves, outs, SGR_FWD_REL)
            masked = saves[:, x["mask"] <= 0]
            zero = bool((masked == 0).all())
            same_fwd = torch.equal(saves, again)
            log(f"  {tag}: saves over NaN-filled memory: {masked.shape[1]} masked rows a step "
                f"exactly zero: {zero}; two forward calls bit-identical: {same_fwd}")
            if not zero:
                raise AssertionError(f"{tag}: the forward left masked rows nonzero")
            if not same_fwd:
                raise AssertionError(f"{tag}: the forward is not deterministic")
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
                res["fwd_saves_rel_err"] = e_saves
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
            res["launch_ms" + suf] = _launch_ms(lambda: sgr_reason_fused(**xd))
            res["plain_ms" + suf] = cuda_ms(lambda: sgr_reason_plain(**xd), reps=5)
        res["bwd_ms" + suf] = cuda_ms(lambda: sgr_reason_bwd_fused(**xd, outs=outs, g=cot),
                                      reps=10)
        res["bwd_plain_ms" + suf] = cuda_ms(
            lambda: sgr_reason_bwd_plain(**xd, outs=outs, g=cot), reps=5)
        res["bwd_launch_ms" + suf] = _launch_ms(
            lambda: sgr_reason_bwd_fused(**xd, outs=outs, g=cot))
        for pre, bwd in (("", False), ("bwd_", True)):
            for k, v in sgr_train_bound(xd["s0"], xd["mask"], steps, bwd).items():
                res[pre + k + suf] = v
            res[pre + "tflops" + suf] = res[pre + "product_flop" + suf] / (
                res[pre + "ms" + suf] * 1e9)
            res[pre + "share_of_bound" + suf] = res[pre + "bound_ms" + suf] / res[pre + "ms" + suf]
    # neither wrapper reads anything back to the host: a synchronizing call
    # under the sync debug mode raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            sgr_reason_fused(**xd)
        sgr_reason_bwd_fused(**xd, outs=outs, g=cot)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res["fwd_no_sync"] = res["bwd_no_sync"] = True
    res["nodes_per_pair_mean"] = float(x["mask"].sum(dim=1).mean())
    # no single PyTorch call computes the reasoning chain or its backward
    res["library_ms"] = None
    log(f"  time {pairs} pairs x {l + 1} nodes (mean {res['nodes_per_pair_mean']:.2f} valid), "
        f"S {s}, sgr_step {steps}, fp32: forward kernels {res['ms']:.3f} ms (the FMA design: "
        f"{SGR_FWD_FMA_MS[0]:.3f}), plain {res['plain_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.4f} ms at the TF32 peak ({res['bound_by']}; "
        f"{res['bound_ms_fp32_peak']:.4f} ms at the fp32 peak, "
        f"{res['bound_ms_bf16_peak']:.4f} ms at the bf16 peak), products "
        f"{res['tflops']:.2f} TFLOP/s, {100 * res['share_of_bound']:.2f}% of the bound; "
        f"backward kernels {res['bwd_ms']:.3f} ms (the FMA design: {SGR_BWD_FMA_MS[0]:.3f}), "
        f"plain {res['bwd_plain_ms']:.3f} ms, bound {res['bwd_bound_ms']:.4f} ms at the TF32 "
        f"peak ({res['bwd_bound_by']}; {res['bwd_bound_ms_fp32_peak']:.4f} ms at the fp32 "
        f"peak, {res['bwd_bound_ms_bf16_peak']:.4f} ms at the bf16 peak), products "
        f"{res['bwd_tflops']:.2f} TFLOP/s, {100 * res['bwd_share_of_bound']:.2f}% of the "
        f"bound; bf16 nodes: forward {res['ms_bf16']:.3f} ms (the FMA design: "
        f"{SGR_FWD_FMA_MS[1]:.3f}; plain {res['plain_ms_bf16']:.3f}, bound "
        f"{res['bound_ms_bf16']:.4f}, products {res['tflops_bf16']:.2f} TFLOP/s, "
        f"{100 * res['share_of_bound_bf16']:.2f}%), backward {res['bwd_ms_bf16']:.3f} ms (the "
        f"FMA design: {SGR_BWD_FMA_MS[1]:.3f}; plain {res['bwd_plain_ms_bf16']:.3f}, bound "
        f"{res['bwd_bound_ms_bf16']:.4f}, products {res['bwd_tflops_bf16']:.2f} TFLOP/s, "
        f"{100 * res['bwd_share_of_bound_bf16']:.2f}%)")
    for suf, tag in (("", "fp32"), ("_bf16", "bf16")):
        for kind, key in (("forward", "launch_ms"), ("backward", "bwd_launch_ms")):
            log(f"  {kind} {tag} nodes, device ms a call by launch (profiler): " + ", ".join(
                f"{k} {v:.3f}" for k, v in res[key + suf].items()))
    log("  one forward and one backward call under torch.cuda.set_sync_debug_mode('error'): "
        "no sync")
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


@contextlib.contextmanager
def _gru_plain_route():
    """MaskedGRU with the kernel's wrapper swapped for the plain recurrence
    in the kernel's arithmetic (gru_scan with the carry rounded to bf16
    before the product, as the bf16 kernel rounds it): the same encode's
    plain GRU on the card."""
    saved = kgru.gru_scan_fused
    kgru.gru_scan_fused = functools.partial(gru_scan, dot_dtype=torch.bfloat16)
    try:
        yield
    finally:
        kgru.gru_scan_fused = saved


def _vsrn_text_memory(model) -> None:
    """VSRN's text GRU made a slow integrator: the reference pads every
    caption to max_len + 1 slots and runs its text GRU over the pads
    (itrx_torch/data/precomp.py's parity quirk), and with random weights
    the ~45 pad steps after a caption wash its words out, so every caption
    embeds alike and one image ranks first for all of them.  So the pad
    token's embedding row and the candidate's two biases are zeroed (a pad
    step then only scales the carry) and the update gate's input bias is
    raised by 5 (the carry changes slowly): each caption's words set its
    embedding, and the witness can tell a right grid from a degenerate one
    (the slice prints its distinct top-1 images)."""
    rnn, h = model.txt_enc.rnn, model.txt_enc.rnn.hidden_size
    with torch.no_grad():
        model.txt_enc.embed.weight[0] = 0.0
        rnn.bias_ih_l0[h:2 * h] += 5.0
        rnn.bias_ih_l0[2 * h:] = 0.0
        rnn.bias_hh_l0[2 * h:] = 0.0


def _sentence_shape_problems(dataset, cfg, enc) -> list:
    """One (width,) embedding an image row and a caption: the embed width
    (final_dims for SAEM)."""
    width = cfg["final_dims"] if cfg["name"] == "SAEM" else cfg["embed_size"]
    return [f"unexpected {k} embeddings {tuple(enc[k].shape)}" for k in ("img", "cap")
            if tuple(enc[k].shape) != (len(dataset), width)]


def _vsepp_word_scale(model) -> None:
    """VSE++'s word embeddings scaled by 10.  With the reference's U(-0.1,
    0.1) init a word moves a gate of the H 1024 GRU by ~2e-2 against biases
    of ~3e-2, so every caption's last state is mostly the biases': on a CPU
    run at the slice's widths over 100 images and 500 captions the captions'
    mean cosine was 0.94 and 3 images were top-1 for all of them; scaled,
    the words set the state (0.76, 17 images), and the witness can tell a
    right grid from a degenerate one (the slice prints its distinct top-1
    images)."""
    with torch.no_grad():
        model.txt_enc.embed.weight.mul_(10.0)


def _saem_word_scale(model) -> None:
    """SAEM's BERT word embeddings scaled by 10.  BERT's embedding sums a
    word's, a position's and a segment's rows, all drawn with std 0.02, and
    normalizes the sum, so with random weights the position rows, which
    every caption shares, set half of each slot, and the text head's max
    over all 32 slots keeps a part common to every caption.  On the card at
    the slice's widths (itrx_torch/tools/saem_word_scale.py) the captions'
    mean cosine was 0.963 and 19 images were top-1 for all 5000 of them;
    scaled, the words set each slot (0.916, 49 images; with the rnn heads
    0.927 -> 0.778, 23 -> 64), and the witness can tell a right grid from a
    degenerate one."""
    with torch.no_grad():
        model.txt_enc.bert.embeddings.word_embeddings.weight.mul_(10.0)


def gru_witness(model, dataset, cfg, enc, sims, launches) -> tuple:
    """The witness of a slice whose GRUs run inside encode, in bf16 (VSRN's
    text and region GRUs at H 2048, VSE++'s text GRU at H 1024, SAEM's rnn
    heads): the main path's bf16 grid against the grid of the same bf16
    encode with the GRU swapped for its plain pair on the card
    (_gru_plain_route), top-1 agreement >= TOP1_MIN with >= 2 distinct top-1
    images, and the two encodes' embeddings within GRU_EMBED_BF16_ATOL; the
    largest grid difference is reported.  Returns (the fields it measured,
    the failed checks)."""
    problems = _sentence_shape_problems(dataset, cfg, enc)
    with _gru_plain_route():
        t0 = time.perf_counter()
        plain = encode(model, dataset, cfg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    emb_err = {k: float((enc[k].float() - plain[k].float()).abs().max()) for k in ("img", "cap")}
    err, agree, distinct = _top1(sims, grid_of(model, plain, dataset.im_div))
    out = {
        "plain_gru_encode_seconds": plain_s,
        "embedding_max_abs_diff_kernel_vs_plain_gru": emb_err,
        "grid_max_abs_diff_kernel_vs_plain_gru": err,
        "top1_agreement_kernel_vs_plain_gru": agree,
        "distinct_top1_images": distinct,
    }
    if distinct < 2:
        problems.append("every caption ranks the same image first: the witness cannot tell a "
                        "right grid from a degenerate one")
    if not agree >= TOP1_MIN:
        problems.append(f"the bf16 grid through the GRU kernel agrees with the plain GRU's on "
                        f"only {agree:.4f} of top-1 images (< {TOP1_MIN})")
    if not max(emb_err.values()) <= GRU_EMBED_BF16_ATOL:
        problems.append(f"the bf16 embeddings through the GRU kernel differ from the plain "
                        f"GRU's by {emb_err} (> {GRU_EMBED_BF16_ATOL})")
    return out, problems


def saem_witness(model, dataset, cfg, enc, sims, launches) -> tuple:
    """SAEM's witness: the main path's bf16 grid against the grid of an
    fp32 encode and an fp32 grid of the same model on the card, top-1
    agreement >= TOP1_MIN with >= 2 distinct top-1 images, the fp32 top-1
    among the bf16 top 5 on >= SAEM_TOP5_MIN of captions; with an rnn head,
    also gru_witness (the GRU kernel against its plain pair).  Returns (the
    fields it measured, the failed checks)."""
    problems = _sentence_shape_problems(dataset, cfg, enc)
    t0 = time.perf_counter()
    enc32 = engine.encode_data(model, dataset, cfg["batch_size"], device=DEV)
    sims32 = engine.cal_sims(model, enc32["img"][:: dataset.im_div], enc32["cap"],
                             verbose=False)
    torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t0
    err, agree, distinct = _top1(sims, sims32)
    top5 = sims.topk(5, dim=0).indices
    in_top5 = float((top5 == sims32.argmax(dim=0)[None]).any(dim=0).float().mean())
    out = {
        "fp32_encode_and_grid_seconds": fp32_s,
        "rsum_fp32": metrics.cal_recall(sims32, cap_ratio=dataset.im_div, verbose=False)["rsum"],
        "grid_max_abs_diff_bf16_vs_fp32": err,
        "top1_agreement_bf16_vs_fp32": agree,
        "fp32_top1_in_bf16_top5": in_top5,
        "distinct_top1_images_fp32": distinct,
    }
    if distinct < 2:
        problems.append("every caption ranks the same image first in the fp32 grid: the "
                        "witness cannot tell a right grid from a degenerate one")
    if not agree >= TOP1_MIN:
        problems.append(f"the bf16 grid agrees with the fp32 grid on only {agree:.4f} of "
                        f"top-1 images (< {TOP1_MIN})")
    if not in_top5 >= SAEM_TOP5_MIN:
        problems.append(f"the fp32 top-1 image is among the bf16 grid's top 5 on only "
                        f"{in_top5:.4f} of captions (< {SAEM_TOP5_MIN})")
    if "rnn" in (cfg["txt_stru"], cfg.get("img_stru", "trans")):
        seen, more = gru_witness(model, dataset, cfg, enc, sims, launches)
        out.update(seen)
        problems += more
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
    # the VSRN() overlay (embed 2048, RsGCN, text and region GRUs at H 2048,
    # cosine grid through the engine's 2-D tiles): the GRU kernel in bf16 at
    # H 2048 and TorchBatchNorm on bf16, no grid kernel
    "vsrn": ("VSRN", ("gru",), (), gru_witness),
    # VSE++ on precomputed features, the VSE_PP() overlay (fartashf/vsepp
    # README: one 4096-d VGG vector an image, embed 1024, word_dim 300, the
    # one-way GRU's output at the last word; cosine grid through the
    # engine's 2-D tiles) over a flat split: the GRU kernel at H 1024 in bf16
    "vsepp": ("VSE_PP", ("gru",), (), gru_witness),
    # the SAEM() overlay (final_dims 256, the cnn text head over BERT-base
    # with the split's tiny vocabulary, the trans image branch from the
    # port's trans_cfg, max_words 32): no kernel
    "saem": ("SAEM", (), ("bert_path={data_root}",), saem_witness),
    # the same with both rnn heads (bi_gru): the GRU kernel over BERT's last
    # layer (D 768, H embed_size 1024, both directions) and over the regions
    # (D 2048, H final_dims 256, both directions)
    "saem_rnn": ("SAEM", ("gru",),
                 ("bert_path={data_root}", "txt_stru=rnn", "img_stru=rnn", "bi_gru=True"),
                 saem_witness),
}
# a slice's random weights prepared before its main path (see each function)
SLICE_PREPARE = {"vsrn": _vsrn_text_memory, "vsepp": _vsepp_word_scale,
                 "saem": _saem_word_scale, "saem_rnn": _saem_word_scale}


def slice_detail(cfg: dict, model) -> str:
    if cfg["name"] == "VSE_PP":
        return (f"img_dim {cfg['img_dim']}, word_dim {cfg['word_dim']}, text GRU H "
                f"{model.txt_enc.rnn.hidden_size}, {cfg['measure']} grid")
    if cfg["name"] == "SAEM":
        bert = model.txt_enc.bert.config
        return (f"txt_stru {cfg['txt_stru']}, img_stru {cfg.get('img_stru', 'trans')}, bi_gru "
                f"{cfg['bi_gru']}, final_dims {cfg['final_dims']}, max_words "
                f"{cfg['max_words']}, BERT {bert.hidden_size} x {bert.num_hidden_layers} layers")
    if cfg["name"] == "VSRN":
        return (f"text and region GRUs H {model.txt_enc.rnn.hidden_size}, "
                f"{cfg['measure']} grid")
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
    if direction in SLICE_PREPARE:
        SLICE_PREPARE[direction](model)
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


def vsrn_dec_bound(x: dict, backward: bool = False, fma: bool = False,
                   peak: str = "tf32") -> dict:
    """The bound of one decode call (fp32): the inputs read once and the
    outputs written once (the forward's states and residuals; the backward's
    ten cotangents), against the products (forward 2 B H^2 x 7 a step:
    h [Watt | Whh]^T and ctx Wctx^T; backward 2 B H^2 x 18: the recomputed
    hq and gx, g_gx Wctx, the carry's [g_hq | g_gh] [Watt ; Whh] and the
    weight sums) and the attention's elementwise work (about 6 and 16
    operations per (b, r, h) a step).  The products, which both kernels run
    on the tensor cores as split-bf16 products, count at the TF32
    tensor-core peak (`fma`: all at the fp32 peak, the figure of the
    per-step FMA designs; `peak` "bf16": the bf16 mode, one bf16 pass), the
    elementwise work at the fp32 peak.  Bytes at each input's own type; in
    the bf16 mode ghall and g_gxw, bf16 values, at 2 bytes an element.
    Also "product_flop"."""
    t, b, h3 = x["gxw"].shape
    h, r = h3 // 3, x["enc_out"].shape[1]
    ins = nbytes(*x.values())
    gate = 2 if peak == "bf16" else 4  # ghall's and g_gxw's bytes an element
    if backward:
        saves = 4 * t * b * (h + h) + gate * t * b * h3  # hall, g_hs; ghall
        # every cotangent but the mask's, g_gxw at its values' width
        moved = ins + saves + ins - nbytes(x["cmask"], x["gxw"]) + gate * t * b * h3
        products, rest = t * 36.0 * b * h * h, t * 16.0 * b * r * h
    else:
        moved = ins + 4 * t * b * (h + h) + gate * t * b * h3  # hs, hall; ghall
        products, rest = t * 14.0 * b * h * h, t * 6.0 * b * r * h
    ops = {"fp32": products + rest} if fma else {peak: products, "fp32": rest}
    return {**bound(moved, ops), "product_flop": products}


def phase_vsrn_dec(g) -> dict:
    """VSRN's decoder kernels vs their plain pair: the training path's decode
    (59 steps x 128 x 36 regions, H 512) without and with the context
    dropout, and a ragged odd shape; the states, the residuals, all nine
    cotangents (the mask's zero), two forward and two backward calls
    bit-identical; both kernels at the loops' other routes; then the times
    and bounds at the path's shape."""
    log("vsrn_dec decoder forward + backward kernels vs plain (fp32)")
    res = {}
    for t, b, r, h, keep in VSRN_DEC_SHAPES:
        tag = f"vsrn_dec T {t} x B {b} x R {r} x H {h}, keep {keep}"
        x, ghs = _vsrn_dec_inputs(g, t, b, r, h, keep)
        args = tuple(x.values())
        with torch.no_grad():
            got = vsrn_dec_fused(*args)
        k_fwd = kvsrn._launch_fwd(*args, residuals=True, dot=None)
        want, hall, ghall = vsrn_dec_plain(*args)
        e_fwd = check_rel(f"{tag} states", got, want, VSRN_FWD_REL)
        for name, a, w in zip(("states with residuals", "hall", "ghall"), k_fwd,
                              (want, hall, ghall)):
            check_rel(f"{tag} {name}", a, w, VSRN_FWD_REL)
        check_fwd_repeats(tag, args, k_fwd)
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
    gr = torch.Generator().manual_seed(1)
    for t, b, r, h, keep in VSRN_DEC_ROUTE_SHAPES:
        tag = f"vsrn_dec T {t} x B {b} x R {r} x H {h}, keep {keep}"
        x, ghs = _vsrn_dec_inputs(gr, t, b, r, h, keep)
        args = tuple(x.values())
        want = vsrn_dec_plain(*args)
        _, hall, ghall = want
        k_fwd = kvsrn._launch_fwd(*args, residuals=True, dot=None)
        fwd_errs = [rel_err(a, w_) for a, w_ in zip(k_fwd, want)]
        log(f"  {tag} forward ({kvsrn.fwd_plan(b, r, h, sms=kvsrn._sms(DEV))}): states, hall, "
            f"ghall rel_err {', '.join(f'{e:.3e}' for e in fwd_errs)} (limit {VSRN_FWD_REL:g})")
        if not all(torch.isfinite(a).all() for a in k_fwd) or not max(fwd_errs) <= VSRN_FWD_REL:
            raise AssertionError(f"{tag}: forward rel_err {max(fwd_errs)} > {VSRN_FWD_REL}")
        check_fwd_repeats(tag, args, k_fwd)
        kb = vsrn_dec_bwd_fused(*args, hall, ghall, ghs)
        pb = vsrn_dec_bwd_plain(*args, hall, ghall, ghs)
        errs = {n: rel_err(a, w_) for n, a, w_ in zip(VSRN_DEC_NAMES, kb, pb) if n != "g_cmask"}
        worst = max(errs, key=errs.get)
        same = all(torch.equal(a, b_) for a, b_ in
                   zip(kb, vsrn_dec_bwd_fused(*args, hall, ghall, ghs)))
        log(f"  {tag} backward ({kvsrn.plan(b, r, h, sms=kvsrn._sms(DEV))}): largest rel_err "
            f"{errs[worst]:.3e} ({worst}; limit {VSRN_BWD_REL:g}), two calls bit-identical: {same}")
        if not all(torch.isfinite(a).all() for a in kb) or not errs[worst] <= VSRN_BWD_REL:
            raise AssertionError(f"{tag}: {worst} rel_err {errs[worst]} > {VSRN_BWD_REL}")
        if not same or float(kb[1].abs().max()) != 0.0:
            raise AssertionError(f"{tag}: the backward is not deterministic or the mask's "
                                 "cotangent is not 0")
    x, ghs = _vsrn_dec_inputs(g, *VSRN_DEC_SHAPES[1])
    args = tuple(x.values())
    _, hall, ghall = vsrn_dec_plain(*args)
    with torch.no_grad():
        # the training path's forward writes the residuals
        res["ms"] = cuda_ms(lambda: kvsrn._launch_fwd(*args, residuals=True, dot=None), reps=10)
        res["fwd_no_residuals_ms"] = cuda_ms(lambda: vsrn_dec_fused(*args), reps=10)
        res["plain_ms"] = cuda_ms(lambda: vsrn_dec_plain(*args), reps=5)
        res["launch_ms"] = _launch_ms(lambda: kvsrn._launch_fwd(*args, residuals=True, dot=None))
    res["bwd_ms"] = cuda_ms(lambda: vsrn_dec_bwd_fused(*args, hall, ghall, ghs), reps=10)
    res["bwd_launch_ms"] = _launch_ms(lambda: vsrn_dec_bwd_fused(*args, hall, ghall, ghs))
    res["bwd_plain_ms"] = cuda_ms(lambda: vsrn_dec_bwd_plain(*args, hall, ghall, ghs), reps=5)
    res.update(vsrn_dec_bound(x))
    res["bound_ms_fma"] = vsrn_dec_bound(x, fma=True)["bound_ms"]
    res["tflops"] = res["product_flop"] / (res["ms"] * 1e9)
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    res["plan"] = kvsrn.fwd_plan(x["gxw"].shape[1], x["enc_out"].shape[1],
                                 x["enc_out"].shape[2], sms=kvsrn._sms(DEV))
    for k, v in vsrn_dec_bound(x, backward=True).items():
        res["bwd_" + k] = v
    res["bwd_bound_ms_fma"] = vsrn_dec_bound(x, backward=True, fma=True)["bound_ms"]
    res["bwd_tflops"] = res["bwd_product_flop"] / (res["bwd_ms"] * 1e9)
    res["bwd_share_of_bound"] = res["bwd_bound_ms"] / res["bwd_ms"]
    res["bwd_plan"] = kvsrn.plan(x["gxw"].shape[1], x["enc_out"].shape[1],
                                 x["enc_out"].shape[2], sms=kvsrn._sms(DEV))
    # neither kernel reads anything back to the host: a synchronizing call
    # under the sync debug mode raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kvsrn._launch_fwd(*args, residuals=True, dot=None)
        vsrn_dec_bwd_fused(*args, hall, ghall, ghs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res["no_sync"] = True
    # no PyTorch call computes the decode loop or its backward
    res["library_ms"] = None
    t, b, r, h, keep = VSRN_DEC_SHAPES[1]
    log(f"  time T {t} x B {b} x R {r} x H {h} (keep {keep}), fp32: forward kernel "
        f"{res['ms']:.3f} ms with residuals ({res['fwd_no_residuals_ms']:.3f} without; the "
        f"per-step FMA design: {VSRN_FWD_PER_STEP_MS[0]:.3f}, {VSRN_FWD_PER_STEP_MS[1]:.3f}), "
        f"plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
        f"products at the TF32 peak; {res['bound_ms_fma']:.4f} at the fp32 peak), products "
        f"{res['tflops']:.2f} TFLOP/s, {100 * res['share_of_bound']:.2f}% of the bound; loop "
        f"{res['plan']}; backward kernels {res['bwd_ms']:.3f} ms (the per-step FMA design: "
        f"{VSRN_BWD_FMA_MS:.3f}), plain {res['bwd_plain_ms']:.3f} ms, bound "
        f"{res['bwd_bound_ms']:.4f} ms ({res['bwd_bound_by']}, products at the TF32 peak; "
        f"{res['bwd_bound_ms_fma']:.4f} at the fp32 peak), products "
        f"{res['bwd_tflops']:.2f} TFLOP/s, {100 * res['bwd_share_of_bound']:.2f}% of the bound; "
        f"loop {res['bwd_plan']}")
    for what in ("", "bwd_"):
        log(f"  {'backward' if what else 'forward'}, device ms a call by launch (profiler): "
            + ", ".join(f"{k} {v:.3f}" for k, v in res[what + "launch_ms"].items()))
    log("  one forward and one backward call under torch.cuda.set_sync_debug_mode('error'): "
        "no sync")
    return res


# the decoder's bf16 mode (train_bf16) at the training path's decode with
# the 0.2 context dropout, a ragged odd shape, and H 1024 over 128 regions
# and two batch tiles (its half-size fragments resident in both loops, where
# the fp32 mode streams them)
VSRN_DEC_BF16_SHAPES = ((59, 128, 36, 512, 0.8), (7, 37, 5, 96, 0.5), (5, 200, 128, 1024, 0.8))
# the bf16 mode against the plain pair at bf16 dot, max|kernel - plain| /
# max|plain| per output: both round h, the context and the gradients to
# bf16 before each product, so an operand that the two sides form in
# another fp32 order may round one bf16 step apart.  ghall and g_gxw are
# written as bf16 values (2^-7: one step of the largest entry; their
# rounding points held by the share of unequal entries,
# VSRN_BF16_UNEQUAL); the rest is fp32, each limit between the kernel's
# largest reading and the smallest of the plain pair without the roundings
# (fp32 products on unrounded operands), on the H100 at
# VSRN_DEC_BF16_SHAPES, on BF16_MODES_SEED's inputs and on another draw:
# states 1.8e-4 and 7.6e-4, hall 1.5e-4 and 6.7e-4, g_enc_out 3.9e-4 and
# 1.07e-3, g_enc_att 3.1e-4 and 9.3e-4, g_h0 3.0e-4 and 4.2e-4, dWatt
# 1.1e-3 and 2.3e-3, dw2 3.0e-4 and 1.04e-3, dWctx 3.8e-4 and 1.66e-3, dWhh
# 5.5e-4 and 1.58e-3, dbhh 9.0e-5 and 1.9e-4; the shares of unequal
# entries, ghall 0.090 and 0.42, g_gxw 0.040 and 0.11 (the plain pair's
# output alone rounded).  Each reading must pass its limit, and the plain
# pair without the roundings must fail it
VSRN_BF16_REL = {"states": 4e-4, "hall": 4e-4, "ghall": 2.0 ** -7, "g_gxw": 2.0 ** -7,
                 "g_enc_out": 6e-4, "g_enc_att": 6e-4, "g_h0": 3.6e-4, "dWatt": 1.6e-3,
                 "dw2": 6e-4, "dWctx": 8e-4, "dWhh": 9e-4, "dbhh": 1.3e-4}
VSRN_BF16_UNEQUAL = {"ghall": 0.2, "g_gxw": 0.07}


def unequal_share(got, want) -> float:
    """The share of entries that differ at all."""
    return float((got != want).float().mean())


def check_rounding_points(tag: str, unrounded: float, limit: float) -> None:
    """An fp32 output of a bf16 mode: the plain version without the bf16
    roundings must read beyond the kernel's limit, so that a kernel which
    skips a rounding (or runs the fp32 mode's products) fails it."""
    log(f"    {tag}: the plain version without the bf16 roundings: rel_err {unrounded:.3e} "
        f"(must exceed {limit:g})")
    if not unrounded > limit:
        raise AssertionError(f"{tag}: the limit {limit} does not separate the plain version "
                             f"without the bf16 roundings ({unrounded})")


def check_unequal(tag: str, got, want, unrounded, limit: float) -> float:
    """An output written as bf16 values: the share of its entries unequal to
    the plain version's within `limit`, and the plain version without the
    bf16 roundings, its output alone rounded to bf16, beyond it."""
    share = unequal_share(got, want)
    far = unequal_share(unrounded.to(torch.bfloat16).to(want.dtype), want)
    log(f"    {tag}: entries unequal {share:.4f} (limit {limit:g}); the plain version without "
        f"the bf16 roundings, its output rounded: {far:.4f} (must exceed the limit)")
    if not share <= limit:
        raise AssertionError(f"{tag}: {share} of the entries differ, limit {limit}")
    if not far > limit:
        raise AssertionError(f"{tag}: the limit {limit} does not separate the plain version "
                             f"without the bf16 roundings ({far})")
    return share


def _bf16_dec_args(x: dict) -> tuple:
    """The decoder's operands as its bf16 mode takes them: enc_out, Watt,
    Wctx and Whh bf16, the rest fp32."""
    return tuple(v.to(torch.bfloat16) if n in ("enc_out", "watt", "wctx", "whh") else v
                 for n, v in x.items())


def phase_vsrn_dec_bf16(g) -> dict:
    """VSRN's decoder kernels in their bf16 mode (train_bf16) vs the plain
    pair at dot_dtype bf16 (itrx's kernel at dot_dtype="bfloat16"): the
    states and residuals, every cotangent, a dropped step's gradient beside
    each reading, two forward and two backward calls bit-identical, at
    VSRN_DEC_BF16_SHAPES; then both timed beside the fp32 mode, with their
    bounds at the bf16 peak."""
    log("vsrn_dec decoder kernels, bf16 mode, vs the plain pair at bf16 dot")
    bf = torch.bfloat16
    res = {}
    for t, b, r, h, keep in VSRN_DEC_BF16_SHAPES:
        tag = f"vsrn_dec bf16 T {t} x B {b} x R {r} x H {h}, keep {keep}"
        log(f"  {tag}: {kvsrn.fwd_plan(b, r, h, sms=kvsrn._sms(DEV), bf16=True)}, "
            f"{kvsrn.plan(b, r, h, sms=kvsrn._sms(DEV), bf16=True)}")
        x, ghs = _vsrn_dec_inputs(g, t, b, r, h, keep)
        args = _bf16_dec_args(x)
        with torch.no_grad():
            got = vsrn_dec_fused(*args)
        k_fwd = kvsrn._launch_fwd(*args, residuals=True, dot=bf)
        want, hall, ghall = vsrn_dec_plain(*args, dot_dtype=bf)
        unrounded = vsrn_dec_plain(*args)
        e_fwd = check_rel(f"{tag} states", got, want, VSRN_BF16_REL["states"])
        for name, a, w_, n_ in zip(("states with residuals", "hall", "ghall"), k_fwd,
                                   (want, hall, ghall), unrounded):
            key = name.split()[0]
            check_rel(f"{tag} {name}", a, w_, VSRN_BF16_REL[key])
            if key == "ghall":
                check_unequal(f"{tag} ghall", a, w_, n_, VSRN_BF16_UNEQUAL["ghall"])
            else:
                check_rounding_points(f"{tag} {name}", rel_err(n_, w_), VSRN_BF16_REL[key])
        check_fwd_repeats(tag, args, k_fwd, bf)
        kb = vsrn_dec_bwd_fused(*args, hall, ghall, ghs)
        pb = vsrn_dec_bwd_plain(*args, hall, ghall, ghs, dot_dtype=bf)
        lost = ghs.clone()
        lost[1] = 0.0
        lb = vsrn_dec_bwd_plain(*args, hall, ghall, lost, dot_dtype=bf)
        nb = vsrn_dec_bwd_plain(*args, hall, ghall, ghs)
        if float(kb[1].abs().max()) != 0.0:
            raise AssertionError(f"{tag}: the mask's cotangent is not 0")
        errs = {}
        for name, a, w_, c_, n_ in zip(VSRN_DEC_NAMES, kb, pb, lb, nb):
            if name == "g_cmask":
                continue
            limit = VSRN_BF16_REL[name]
            errs[name] = rel_err(a.float(), w_.float())
            wrong = rel_err(c_.float(), w_.float())
            log(f"  {tag} backward {name}: rel_err {errs[name]:.3e} (limit {limit:g}; with "
                f"step 1's cotangent dropped: {wrong:.3e})")
            if not torch.isfinite(a).all() or not errs[name] <= limit:
                raise AssertionError(f"{tag}: {name} rel_err {errs[name]} > {limit}")
            if not wrong > limit:
                raise AssertionError(f"the limit {limit} does not separate a lost step "
                                     f"({wrong}) in {name}")
            if name == "g_gxw":
                check_unequal(f"{tag} {name}", a, w_, n_, VSRN_BF16_UNEQUAL[name])
            else:
                check_rounding_points(f"{tag} {name}", rel_err(n_.float(), w_.float()), limit)
        check_bit_identical(f"{tag} backward", kb, vsrn_dec_bwd_fused(*args, hall, ghall, ghs))
        if (t, b, r, h, keep) == VSRN_DEC_BF16_SHAPES[0]:
            res["max_abs_err"] = float((got - want).abs().max())
            res["fwd_rel_err"] = e_fwd
            res["bwd_max_abs_err"] = max(float((a - w_).abs().max()) for a, w_ in zip(kb, pb))
            res["bwd_rel_err"] = errs
    x, ghs = _vsrn_dec_inputs(g, *VSRN_DEC_BF16_SHAPES[0])
    args, args32 = _bf16_dec_args(x), tuple(x.values())
    _, hall, ghall = vsrn_dec_plain(*args, dot_dtype=bf)
    _, hall32, ghall32 = vsrn_dec_plain(*args32)
    with torch.no_grad():
        res["ms"] = cuda_ms(lambda: kvsrn._launch_fwd(*args, residuals=True, dot=bf), reps=10)
        res["fp32_ms"] = cuda_ms(lambda: kvsrn._launch_fwd(*args32, residuals=True, dot=None), reps=10)
        res["plain_ms"] = cuda_ms(lambda: vsrn_dec_plain(*args, dot_dtype=bf), reps=5)
    res["bwd_ms"] = cuda_ms(lambda: vsrn_dec_bwd_fused(*args, hall, ghall, ghs), reps=10)
    res["bwd_fp32_ms"] = cuda_ms(lambda: vsrn_dec_bwd_fused(*args32, hall32, ghall32, ghs),
                                 reps=10)
    res["bwd_launch_ms"] = _launch_ms(lambda: vsrn_dec_bwd_fused(*args, hall, ghall, ghs))
    res["bwd_plain_ms"] = cuda_ms(
        lambda: vsrn_dec_bwd_plain(*args, hall, ghall, ghs, dot_dtype=bf), reps=5)
    bx = dict(zip(x, args))
    res.update(vsrn_dec_bound(bx, peak="bf16"))
    for k, v in vsrn_dec_bound(bx, backward=True, peak="bf16").items():
        res["bwd_" + k] = v
    t, b, r, h, keep = VSRN_DEC_BF16_SHAPES[0]
    res["plan"] = kvsrn.fwd_plan(b, r, h, sms=kvsrn._sms(DEV), bf16=True)
    res["bwd_plan"] = kvsrn.plan(b, r, h, sms=kvsrn._sms(DEV), bf16=True)
    res["library_ms"] = None
    log(f"  time T {t} x B {b} x R {r} x H {h} (keep {keep}), bf16 mode: forward kernel "
        f"{res['ms']:.3f} ms with residuals (fp32 mode {res['fp32_ms']:.3f}), plain "
        f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}, products "
        f"at the bf16 peak); backward kernels {res['bwd_ms']:.3f} ms (fp32 mode "
        f"{res['bwd_fp32_ms']:.3f}), plain {res['bwd_plain_ms']:.3f} ms, bound "
        f"{res['bwd_bound_ms']:.4f} ms ({res['bwd_bound_by']}); loops {res['plan']}, "
        f"{res['bwd_plan']}")
    log("  backward, device ms a call by launch (profiler): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["bwd_launch_ms"].items()))
    return res


def check_fwd_repeats(tag: str, args, first, dot=None) -> None:
    """A second forward call with residuals (in the mode `dot`) gives the
    same states, hall and ghall bit for bit."""
    again = kvsrn._launch_fwd(*args, residuals=True, dot=dot)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"  {tag}: two forward calls bit-identical: {same}")
    if not same:
        raise AssertionError(f"{tag}: the forward is not deterministic")


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


def agsa_bound(args, fma: bool = False) -> dict:
    """The bound of one call: q, k, v, the weights and biases read once and
    the output written once, against the products (four (N, d_k) x (d_k,
    d_k) gate products and the two (N, N, d_k) attention products a head) at
    the tensor-core peak of the inputs' type (fp32 products at the TF32
    peak, as the kernels run them; `fma`: at the fp32 FMA peak, the PR 11-12
    convention)."""
    q = args[0]
    b, n, d = q.shape
    dk = args[3].shape[0]
    heads = b * d // dk
    ops = heads * (8 * n * dk * dk + 4 * n * n * dk)
    kind = "bf16" if q.dtype == torch.bfloat16 else "fp32" if fma else "tf32"
    return bound(nbytes(*args) + nbytes(q), {kind: ops})


def agsa_bwd_bound(args, g_out, fma: bool = False) -> dict:
    """The bound of one backward call: q, k, v, g_out, the weights and
    biases read once, dq, dk, dv and the eight weight cotangents written
    once, against the recomputed forward up to the scores (the four gate
    products and q k^T: 8 N d_k^2 + 2 N^2 d_k a head; the backward needs no
    p v) and the adjoints (the four (N, N, d_k) attention products, the two
    gate products g W, the two dq / dk products and the four weight sums:
    16 N d_k^2 + 8 N^2 d_k a head) at the tensor-core peak of the inputs'
    type (fp32 at the TF32 peak; `fma`: at the fp32 FMA peak)."""
    q = args[0]
    b, n, d = q.shape
    dk = args[3].shape[0]
    heads = b * d // dk
    ops = heads * (24 * n * dk * dk + 10 * n * n * dk)
    kind = "bf16" if q.dtype == torch.bfloat16 else "fp32" if fma else "tf32"
    return bound(nbytes(*args, g_out) + 3 * nbytes(q) + 4 * (4 * dk * dk + 4 * dk), {kind: ops})


def _agsa_bwd_check(tag, args, g_out, h, limit) -> tuple:
    """The backward kernels vs agsa_attention_bwd_plain: every cotangent
    within `limit` of its scale, two calls bit-identical, and the plain
    backward with fc_g's halves swapped outside the limit.  Returns (the
    largest relative error, the largest absolute error, the kernels'
    cotangents)."""
    dt = args[0].dtype
    got = agsa_attention_bwd_fused(*args, g_out, h)
    again = agsa_attention_bwd_fused(*args, g_out, h)
    want = agsa_attention_bwd_plain(*args, g_out, h)
    swapped = args[:7] + [args[9], args[10], args[7], args[8]]
    wrong = max(rel_err(a.float(), b.float()) for a, b in
                zip(agsa_attention_bwd_plain(*swapped, g_out, h)[:3], want[:3]))
    torch.cuda.synchronize()
    rels, abss = [], []
    for name, a, b in zip(AGSA_BWD_NAMES, got, want):
        want_dt = dt if name in ("dq", "dk", "dv") else torch.float32
        if a.dtype != want_dt:
            raise AssertionError(f"{tag} {name}: dtype {a.dtype}, expected {want_dt}")
        rels.append(check_rel(f"{tag} {name}", a, b, limit))
        abss.append(float((a.float() - b.float()).abs().max()))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag}: two backward calls differ")
    log(f"  {tag}: two backward calls bit-identical; the plain backward with fc_g's "
        f"halves swapped: {wrong:.3e}")
    if not wrong > limit:
        raise AssertionError(f"the limit {limit} does not separate swapped gate halves "
                             f"({wrong})")
    return max(rels), max(abss), got


def cuda_ms_spread(fn, runs: int = 5, reps: int = 20) -> tuple:
    """(median, least, most) mean milliseconds a call over `runs` runs of
    `reps` calls each (CUDA events), after one warm-up run."""
    times = [cuda_ms(fn, reps=reps, warmup=3 if i == 0 else 0) for i in range(runs)]
    return statistics.median(times), min(times), max(times)


def _agsa_check(tag, args, g_out, h, limit, bwd_limit, exact: bool) -> tuple:
    """The forward kernel vs agsa_attention_plain within `limit` of scale
    (and, where `exact`, equal to it bit for bit), two forward calls
    bit-identical and the plain output with fc_g's halves swapped outside
    the limit; then the backward (`_agsa_bwd_check`).  Returns (the
    forward's relative error, its largest absolute error, the count of its
    elements that differ from the plain output, the backward's relative and
    absolute errors)."""
    dt = args[0].dtype
    with torch.no_grad():
        got = agsa_attention_fused(*args, h)
        again = agsa_attention_fused(*args, h)
        want = agsa_attention_plain(*args, h)
        swapped = args[:7] + [args[9], args[10], args[7], args[8]]
        wrong = rel_err(agsa_attention_plain(*swapped, h).float(), want.float())
    if got.dtype != dt:
        raise AssertionError(f"{tag}: output dtype {got.dtype}")
    err = check_rel(tag, got, want, limit)
    differ = int((got != want).sum())
    log(f"  {tag}: {differ} of {got.numel()} elements differ from the plain output"
        f"{' (must be 0)' if exact else ''}")
    if exact and differ:
        raise AssertionError(f"{tag}: the forward is not bit-identical to agsa_attention_plain "
                             f"({differ} elements differ)")
    if not torch.equal(got, again):
        raise AssertionError(f"{tag}: two forward calls differ")
    log(f"  {tag}: two forward calls bit-identical; the plain output with fc_g's halves "
        f"swapped: {wrong:.3e}")
    if not wrong > limit:
        raise AssertionError(f"the limit {limit} does not separate swapped gate halves ({wrong})")
    bwd_tag = tag.replace("agsa_attn", "agsa_attn_bwd")
    bwd_rel, bwd_abs, _ = _agsa_bwd_check(bwd_tag, args, g_out, h, bwd_limit)
    return err, float((got.float() - want.float()).abs().max()), differ, bwd_rel, bwd_abs


def phase_agsa(g) -> dict:
    """CAMERA's gated attention kernels (forward, and backward) vs
    agsa_attention_plain and agsa_attention_bwd_plain on the card, fp32 and
    bf16: the image and text towers' calls (128 x 64 heads x 36 or 32 x
    d_k 32), the image tower's at B 129, a ragged odd shape and the largest
    the limits allow; then the plans, times (median of 5 with the spread)
    and bounds at the towers' shapes, and SDPA on the image tower's gated
    qm, km and v as a yardstick of the attention half alone."""
    log("agsa_attn gated attention kernels (forward and backward) vs plain (fp32 and bf16)")
    res = {}
    shapes = AGSA_SHAPES[:1] + (AGSA_RAGGED_GRID,) + AGSA_SHAPES[1:]
    for b, h, n, dk in shapes:
        x32 = _agsa_inputs(g, b, h, n, dk)
        g32 = torch.randn(b, n, h * dk, generator=g).to(DEV)
        for dt, limit, bwd_limit in ((torch.float32, AGSA_FP32_REL, AGSA_BWD_REL),
                                     (torch.bfloat16, AGSA_BF16_REL, AGSA_BWD_BF16_REL)):
            # every input in the activation dtype, as a bf16 encode casts the
            # parameters (the wrappers read the biases in fp32)
            args = [t.to(dt) for t in x32]
            g_out = g32.to(dt)
            mode = str(dt)[6:]
            tag = f"agsa_attn B {b} x h {h} x N {n} x d_k {dk} {mode}"
            exact = (b, h, n, dk) in AGSA_EXACT_SHAPES
            err, abs_err, differ, bwd_rel, bwd_abs = _agsa_check(tag, args, g_out, h, limit,
                                                                 bwd_limit, exact)
            res[f"B{b}_N{n}_dk{dk}_{mode}_differ"] = differ
            if (b, h, n, dk) not in AGSA_SHAPES[:2]:
                continue
            tower = "img" if n == AGSA_SHAPES[0][2] else "txt"
            key = f"{tower}_{mode}"
            bf16 = dt == torch.bfloat16
            # the bf16 backward keeps its first design (csrc/agsa_attn_bwd.cu)
            plans = {"fwd": agsa_fwd_plan(b, n, h, dk, bf16, DEV.index),
                     "bwd": "the PR 12 design" if bf16 else agsa_plan(b, n, h, dk, DEV.index)}
            with torch.no_grad():
                fwd = cuda_ms_spread(lambda: agsa_attention_fused(*args, h))
                res[f"{key}_plain_ms"] = cuda_ms(lambda: agsa_attention_plain(*args, h), reps=5)
                bwd = cuda_ms_spread(lambda: agsa_attention_bwd_fused(*args, g_out, h))
                res[f"{key}_bwd_plain_ms"] = cuda_ms(
                    lambda: agsa_attention_bwd_plain(*args, g_out, h), reps=5)
            res[f"{key}_ms"], res[f"{key}_bwd_ms"] = fwd[0], bwd[0]
            for pre, bd, old in (("", agsa_bound(args), agsa_bound(args, fma=True)),
                                 ("bwd_", agsa_bwd_bound(args, g_out),
                                  agsa_bwd_bound(args, g_out, fma=True))):
                res[f"{key}_{pre}bound_ms"] = bd["bound_ms"]
                res[f"{key}_{pre}bound_by"] = bd["bound_by"]
                res[f"{key}_{pre}bound_fma_ms"] = old["bound_ms"]
            res[f"{key}_max_abs_err"], res[f"{key}_rel_err"] = abs_err, err
            res[f"{key}_bwd_max_abs_err"], res[f"{key}_bwd_rel_err"] = bwd_abs, bwd_rel
            i = 0 if tower == "img" else 1
            for pre, name, t in (("", "agsa_attn", fwd), ("bwd_", "agsa_attn_bwd", bwd)):
                d = "fwd" if not pre else "bwd"
                log(f"  time {tag.replace('agsa_attn', name)}: kernel{'s' if pre else ''} "
                    f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f}; first design: "
                    f"{AGSA_FMA_MS[f'{d}_{mode}'][i]:.3f}), plain "
                    f"{res[f'{key}_{pre}plain_ms']:.4f} ms, bound "
                    f"{res[f'{key}_{pre}bound_ms']:.4f} ms ({res[f'{key}_{pre}bound_by']}, "
                    f"fp32 products at the TF32 peak; {res[f'{key}_{pre}bound_fma_ms']:.4f} at "
                    f"the fp32 FMA peak), {100 * res[f'{key}_{pre}bound_ms'] / t[0]:.1f}% of it "
                    f"({100 * res[f'{key}_{pre}bound_fma_ms'] / t[0]:.1f}% of the FMA-peak one); "
                    f"plan {plans[d]}")
            if tower == "img":
                # the attention half alone, on the gated qm and km the chain
                # computes: the yardstick no call of the port makes
                c = agsa_chain(*args, h)
                qm, km, v = (c[x].to(dt) for x in ("qm", "km", "vh"))
                sdpa = torch.nn.functional.scaled_dot_product_attention
                with torch.no_grad():
                    res[f"{key}_sdpa_ms"] = cuda_ms(lambda: sdpa(qm, km, v, scale=1.0))
                log(f"  SDPA on the gated qm, km, v of {tag}: {res[f'{key}_sdpa_ms']:.4f} ms "
                    f"(the attention half alone; not the gated function)")
    # the forward's row of the kernels line: the image tower's call in bf16,
    # the encode_bf16 main path's; the backward's: fp32, the training path's
    key = "img_bfloat16"
    res.update(max_abs_err=res[f"{key}_max_abs_err"], ms=res[f"{key}_ms"],
               plain_ms=res[f"{key}_plain_ms"], bound_ms=res[f"{key}_bound_ms"],
               bound_by=res[f"{key}_bound_by"])
    # no PyTorch call computes the gated attention or its backward (the gates
    # act on q and k before the scores)
    res["library_ms"] = None
    return res


def agsa_bwd_result(res: dict) -> dict:
    """The backward kernels' row of the kernels line, from the phase's
    result: the image tower's call in fp32, as CAMERA's training runs it."""
    key = "img_float32"
    return {"max_abs_err": res[f"{key}_bwd_max_abs_err"], "ms": res[f"{key}_bwd_ms"],
            "plain_ms": res[f"{key}_bwd_plain_ms"], "bound_ms": res[f"{key}_bwd_bound_ms"],
            "bound_by": res[f"{key}_bwd_bound_by"], "library_ms": None}


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


def _stat_errs(tag, got, want) -> dict:
    """Each BatchNorm running statistic after the first step, held to
    TRAIN_STAT_REL of its scale.  A running mean is a mean of centred values
    (~0 by cancellation), so it is held in units of its channel's standard
    deviation."""
    errs = {}
    for k in want:
        var = want[k.replace("running_mean", "running_var")]
        scale = max(float(want[k].abs().max()), float(var.max()) ** 0.5)
        errs[k] = float((got[k] - want[k]).abs().max()) / scale
        log(f"  first step {k} ({tag}): {errs[k]:.3e} of scale (limit {TRAIN_STAT_REL:g})")
        if not errs[k] <= TRAIN_STAT_REL:
            raise AssertionError(f"first-step {k} differs {tag} by {errs[k]}")
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


def _no_dropout(model) -> None:
    """Every dropout of the model at rate 0 (SAEM's witness: the two
    devices' random streams differ)."""
    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.p = 0.0


def _relu_decision(module, inputs, out, name, seen, pin):
    """A forward hook on a module whose output feeds a ReLU: records the
    ReLU's decisions (out > 0) of the module's first call in seen[name];
    with `pin`, turns each entry whose decision differs from pin[name] to
    the other side of zero (its magnitude kept, the gradient passed
    through), so that the step takes those decisions."""
    pos = out > 0
    seen.setdefault(name, pos.detach().cpu())
    if pin is None:
        return None
    flip = pos != pin[name].to(out.device)
    return out - 2 * torch.where(flip, out.detach(), torch.zeros_like(out))


def _exact_errs(got, exact, floor, scale) -> dict:
    """Each trained gradient of the card's step (`got`) against the float64
    step that took the card's decisions (`exact`), in units of the larger of
    its float64 largest entry and `floor` x scale, held to EXACT_GRAD_REL;
    ZERO_GRADS held to noise.  Logs every reading before it fails."""
    errs, bad = {}, []
    for k in exact:
        if k in ZERO_GRADS:
            errs[k] = float(got[k].abs().max()) / scale
            log(f"  first step grad {k} (zero in exact arithmetic, card): {errs[k]:.3e} of the "
                f"largest float64 gradient (limit {ZERO_GRAD_REL:g})")
            if not errs[k] <= ZERO_GRAD_REL:
                bad.append(k)
            continue
        den = max(float(exact[k].abs().max()), floor * scale)
        errs[k] = float((got[k] - exact[k]).abs().max()) / den
        log(f"  first step grad {k} (card vs float64): {errs[k]:.3e} of scale "
            f"(limit {EXACT_GRAD_REL:g})")
        if not torch.isfinite(got[k]).all() or not errs[k] <= EXACT_GRAD_REL:
            bad.append(k)
    if bad:
        raise AssertionError(f"first step grads off the float64 step: {bad}")
    return {k: v for k, v in errs.items() if k not in ZERO_GRADS}


def _first_step_witness(cfg, batch, grad_rel: float = TRAIN_GRAD_REL, floor: float = 0.0,
                        kernel_rel: float | None = None, plain_route=None,
                        prepare=None, exact: tuple = ()) -> dict:
    """The first training step's loss, gradients and BatchNorm running
    statistics on the card (the kernels) against the same step on a CPU
    copy (plain path throughout), from one seed's weights and one batch, in
    train mode.  Each trained parameter's gradient's max abs error is held
    to `grad_rel` of the larger of its own largest entry and `floor` of the
    model's largest gradient entry (SGR: see SGR_FLOOR); a frozen one (CAMERA's
    BERT) must get none.  With `kernel_rel`, the card's gradients are also
    held to that limit against the same step on the card with the kernels'
    wrappers swapped for their plain pairs by `plain_route` (SGRAF:
    `_sgraf_plain_chain`, CAMERA: `_agsa_plain_route`), which tells the
    kernels' share of the card-vs-CPU difference; the loss and the running
    statistics are held to that step too.  With `exact` (CAMERA: the
    modules whose outputs feed a ReLU), the gradients are held to a float64
    copy of the step on the CPU that takes the card's ReLU decisions
    (`_relu_decision`, `_exact_errs`) instead, the decisions that differ
    from float64 are counted on both devices, and the fp32 card-vs-CPU
    difference is only reported.
    `prepare(model)`, when given, sets the weights before the step (VSRN:
    `_vsrn_off_identity`)."""
    def step_on(dev, plain=False, dtype=torch.float32, pin=None):
        model = get_model(cfg, device=dev,
                          generator=torch.Generator().manual_seed(cfg["seed"])).train()
        if prepare is not None:
            prepare(model)
        seen = {}
        hooks = [mod.register_forward_hook(functools.partial(_relu_decision, name=name,
                                                             seen=seen, pin=pin))
                 for name, mod in model.named_modules() if name and name.startswith(exact)]
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if dtype != torch.float32:
            model.to(dtype)
            b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
        with plain_route() if plain else contextlib.nullcontext():
            loss, _ = model.loss(b, train=True)
            loss.backward()
        # copies: on the CPU .cpu() would alias the buffers that the next
        # train-mode call updates
        stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        with torch.no_grad():
            e = model.embed(b)
            scores = model.similarity(e["img"], e["cap"], e.get("cap_mask"), train=True)
            if exact and e["img"].dim() == 3:  # each pair's best view (CAMERA)
                seen["views"] = torch.einsum("ikd,cd->ikc", e["img"].double(),
                                             e["cap"].double()).argmax(1).cpu()
        for h in hooks:
            h.remove()
        frozen = [k for k, p in model.named_parameters()
                  if not p.requires_grad and p.grad is None]
        if frozen != [k for k, p in model.named_parameters() if not p.requires_grad]:
            raise AssertionError("a frozen parameter took a gradient")
        # the plain chain leaves bk out of the graph (the fold drops it)
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                 for k, p in model.named_parameters() if p.requires_grad}
        return loss.detach().cpu(), grads, scores.cpu(), stats, seen

    t0 = time.perf_counter()
    (lk, gk, sk, tk, dk), (lc, gc, sc, tc, dc) = step_on(DEV), step_on(torch.device("cpu"))
    log(f"  first-step witness (card, then a CPU copy): {time.perf_counter() - t0:.1f} s")
    loss_err = abs(float(lk) - float(lc)) / abs(float(lc))
    log(f"  first step loss: card {float(lk):.7f}, cpu {float(lc):.7f}, rel_err "
        f"{loss_err:.3e} (limit {TRAIN_LOSS_REL:g})")
    # hardest negatives (max_violation): a near-tie that the two devices break
    # differently would move a row's gradient; report how many agree
    hn_agree = float(((sk - 1e9 * torch.eye(len(sk))).argmax(1)
                      == (sc - 1e9 * torch.eye(len(sc))).argmax(1)).float().mean())
    log(f"  hardest-negative captions agreeing card vs cpu: {hn_agree:.4f}")

    def active(sim):  # the hinge terms above zero, both directions, off the diagonal
        d, off = sim.diagonal(), ~torch.eye(len(sim), dtype=torch.bool)
        margin = cfg.get("margin", 0.2)
        return torch.stack([(margin + sim - d[:, None] > 0) & off,
                            (margin + sim - d[None, :] > 0) & off])

    hinge_flips = None
    if not cfg.get("max_violation"):  # the loss sums every active term
        hinge_flips = int((active(sk) != active(sc)).sum())
        log(f"  hinge terms active on one device only: {hinge_flips} of "
            f"{2 * len(sk) * (len(sk) - 1)} ({int(active(sc).sum())} active on the cpu)")
    if not loss_err <= TRAIN_LOSS_REL:
        raise AssertionError(f"first-step loss differs card vs cpu by {loss_err}")
    scale = max(float(g.abs().max()) for g in gc.values())
    kernel_errs, kernel_stat_errs, plain_err = {}, {}, None
    if kernel_rel is not None:
        lp, gp, _, tp, _ = step_on(DEV, plain=True)
        kernel_loss_err = abs(float(lk) - float(lp)) / abs(float(lp))
        log(f"  first step loss: card kernels {float(lk):.7f}, card plain chain {float(lp):.7f}, "
            f"rel_err {kernel_loss_err:.3e} (limit {TRAIN_LOSS_REL:g})")
        if not kernel_loss_err <= TRAIN_LOSS_REL:
            raise AssertionError(f"first-step loss differs kernels vs plain chain by "
                                 f"{kernel_loss_err}")
        kernel_errs = _grad_errs("card kernels vs card plain chain", gk, gp, kernel_rel,
                                 floor, scale)
        kernel_stat_errs = _stat_errs("card kernels vs card plain chain", tk, tp)
        # the devices' own share, no limit: the same plain chain on both
        plain = {k: float((gp[k] - gc[k]).abs().max()) / max(float(gc[k].abs().max()),
                                                              floor * scale)
                 for k in gc if k not in ZERO_GRADS}
        worst = max(plain, key=plain.get)
        plain_err = plain[worst]
        log(f"  first step grads, the card's plain chain vs cpu (the devices' share, no "
            f"limit): at most {plain_err:.3e} ({worst})")
    exact_errs, flips = {}, {}
    if exact:
        t0 = time.perf_counter()
        l64, g64, _, _, d64 = step_on(torch.device("cpu"), dtype=torch.float64, pin=dk)
        log(f"  float64 CPU step with the card's ReLU decisions: "
            f"{time.perf_counter() - t0:.1f} s; loss {float(l64):.7f}, card "
            f"{abs(float(lk) - float(l64)) / abs(float(l64)):.3e} from it")
        for k in d64:
            flips[k] = (int((dk[k] != d64[k]).sum()), int((dc[k] != d64[k]).sum()))
            log(f"  {'best views' if k == 'views' else 'ReLU decisions after ' + k} "
                f"differing from float64: card {flips[k][0]}, fp32 cpu {flips[k][1]} "
                f"(of {d64[k].numel()})")
        exact_errs = _exact_errs(gk, g64, floor,
                                 max(float(g.abs().max()) for g in g64.values()))
        grad_errs = {k: float((gk[k] - gc[k]).abs().max()) / max(float(gc[k].abs().max()),
                                                                  floor * scale)
                     for k in gc if k not in ZERO_GRADS}
        worst = max(grad_errs, key=grad_errs.get)
        log(f"  first step grads, card vs fp32 cpu (no limit: both held to float64): at "
            f"most {grad_errs[worst]:.3e} ({worst})")
    else:
        grad_errs = _grad_errs("card vs cpu", gk, gc, grad_rel, floor, scale)
    stat_errs = _stat_errs("card vs cpu", tk, tc)
    return {"loss_card": float(lk), "loss_cpu": float(lc), "loss_rel_err": loss_err,
            "grad_rel_err_max": max(grad_errs.values()),
            "exact_grad_rel_err_max": max(exact_errs.values()) if exact_errs else None,
            "decision_flips_vs_float64": flips or None,
            "hinge_flips": hinge_flips,
            "stat_rel_err_max": max(stat_errs.values()) if stat_errs else None,
            "kernel_grad_rel_err_max": max(kernel_errs.values()) if kernel_errs else None,
            "kernel_stat_rel_err_max": (max(kernel_stat_errs.values()) if kernel_stat_errs
                                        else None),
            "plain_chain_grad_rel_err_max": plain_err,
            "hardest_negative_agreement": hn_agree}


# train_bf16's first-step witness: the card's bf16 step against the same
# cast step on a CPU copy.  Two correct bf16 steps differ by where each
# rounds (the card's kernels round h and the gate gradients to bf16 as
# `itrx`'s TPU kernels do; the CPU copy's plain GRU keeps fp32 carries), and
# the rounding moves hinge terms, hardest negatives and softmaxes, so each
# gradient is held to BF16_NOISE_K times the distance bf16 itself puts
# between the CPU's bf16 step and the card's fp32 step (per tensor, L2), up
# to BF16_NOISE_FLOOR of the largest gradient norm (gradients zero in exact
# arithmetic are rounding alone); the tests' reading on the CPU against
# `itrx`: at most 1.13 (tests/test_torch_train_bf16.py)
BF16_NOISE_K = 2.0
BF16_NOISE_FLOOR = 2.0 ** -8
# the first-step losses: card vs CPU copy under the same cast (rounding
# points differ: read on the CPU against `itrx` at most 4.1e-3), and bf16 vs
# fp32 (`itrx`'s own tolerance, tests/test_train_bf16.py)
BF16_LOSS_REL = 1e-2
BF16_VS_FP32_LOSS_REL = 0.03
# the statistics the bf16 forward writes back: bf16 values (one step 2^-8 of
# an entry), from activations that round apart on the two devices
BF16_STAT_REL = 2.0 ** -5


def _bf16_step_witness(cfg, batch, prepare=None) -> dict:
    """train_bf16's first step (train/loop.py::cast_loss) on the card
    against the same cast step on a CPU copy and against the card's fp32
    step, from one seed's weights and one batch: the losses (BF16_LOSS_REL;
    bf16 vs fp32 within BF16_VS_FP32_LOSS_REL), every gradient
    (BF16_NOISE_K, BF16_NOISE_FLOOR), the BatchNorm statistics written back
    as bf16 values in the fp32 buffers (BF16_STAT_REL), the masters and
    their gradients fp32."""
    def step_on(dev, dtype):
        model = get_model(cfg, device=dev,
                          generator=torch.Generator().manual_seed(cfg["seed"])).train()
        if prepare is not None:
            prepare(model)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if dtype is None:
            loss, _ = model.loss(b, train=True)
        else:
            loss, _ = cast_loss(model, b, 0, dtype)
        loss.backward()
        if any(p.dtype != torch.float32 or (p.grad is not None and p.grad.dtype != p.dtype)
               for p in model.parameters()):
            raise AssertionError("a master parameter or its gradient is not fp32")
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return float(loss.detach()), grads, stats

    t0 = time.perf_counter()
    bf = torch.bfloat16
    reset_counters()
    lk, gk, sk = step_on(DEV, bf)
    check_modes(read_counters(), True, "the card's first bf16 step")
    (lc, gc, sc), (l32, g32, _) = step_on(torch.device("cpu"), bf), step_on(DEV, None)
    log(f"  bf16 first-step witness (card, a CPU copy, the card's fp32 step): "
        f"{time.perf_counter() - t0:.1f} s")
    loss_err = abs(lk - lc) / abs(lc)
    vs32 = abs(lk - l32) / abs(l32)
    log(f"  first step loss: card bf16 {lk:.7f}, cpu bf16 {lc:.7f}, rel_err {loss_err:.3e} "
        f"(limit {BF16_LOSS_REL:g}); card fp32 {l32:.7f}, bf16 vs fp32 {vs32:.3e} (limit "
        f"{BF16_VS_FP32_LOSS_REL:g})")
    if not loss_err <= BF16_LOSS_REL or not vs32 <= BF16_VS_FP32_LOSS_REL:
        raise AssertionError(f"bf16 first-step loss: {loss_err} from the CPU copy, {vs32} "
                             "from fp32")
    if set(gk) != set(gc):
        raise AssertionError("the card and the CPU copy trained different parameters")
    floor = BF16_NOISE_FLOOR * max(float(g.norm()) for g in gc.values())
    ratios, on_floor = {}, []
    for k in gc:
        err, noise = float((gk[k] - gc[k]).norm()), float((g32[k] - gc[k]).norm())
        if not torch.isfinite(gk[k]).all() or not err <= BF16_NOISE_K * noise + floor:
            raise AssertionError(f"bf16 first-step gradient {k}: {err} from the CPU copy, "
                                 f"bf16's own distance {noise}, floor {floor}")
        ratios[k] = err / max(noise, 1e-30)
        if err > BF16_NOISE_K * noise:
            on_floor.append(k)
    worst = max(ratios, key=ratios.get)
    log(f"  first step grads, card bf16 vs cpu bf16 over cpu bf16 vs card fp32 (L2, per "
        f"tensor): at most {ratios[worst]:.3f} ({worst}; limit {BF16_NOISE_K:g}, floor "
        f"{floor:.3e}, held by the floor alone: {on_floor or 'none'})")
    stat_errs = {}
    for k in sc:
        if sk[k].dtype != torch.float32 or not torch.equal(sk[k].bfloat16().float(), sk[k]):
            raise AssertionError(f"{k}: not an fp32 buffer of bf16 values")
        stat_errs[k] = float((sk[k] - sc[k]).abs().max()) / max(float(sc[k].abs().max()), 1e-3)
        if not stat_errs[k] <= BF16_STAT_REL:
            raise AssertionError(f"{k}: {stat_errs[k]} > {BF16_STAT_REL}")
    if stat_errs:
        log(f"  BatchNorm statistics after the step, card vs cpu: at most "
            f"{max(stat_errs.values()):.3e} (limit {BF16_STAT_REL:g}), bf16 values in fp32 "
            f"buffers")
    return {"loss_card": lk, "loss_cpu": lc, "loss_fp32": l32, "loss_rel_err": loss_err,
            "loss_vs_fp32": vs32, "grad_noise_ratio_max": ratios[worst],
            "stat_rel_err_max": max(stat_errs.values()) if stat_errs else None}


def _masters_check(state) -> None:
    """After fit under train_bf16: every parameter, every buffer that holds
    values and every Adam moment fp32."""
    model = state.model
    bad = [k for k, p in model.named_parameters() if p.dtype != torch.float32]
    bad += [k for k, b in model.named_buffers() if b.dtype not in (torch.float32, torch.int64)]
    bad += ["adam" for st in state.optimizer.state.values()
            if st["exp_avg"].dtype != torch.float32 or st["exp_avg_sq"].dtype != torch.float32]
    if bad:
        raise AssertionError(f"train_bf16 left non-fp32 masters: {bad[:4]}")
    log("  masters, BatchNorm buffers and Adam moments fp32 after fit")


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
# the launches that some of them must show as (a step, a batch of a
# validation's encode), overrides of the first-step witness, the witness's
# limits and preparation)
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
            {"sgraf_align": (SGRAF_CHUNKS, 0), "sgraf_align_bwd": (SGRAF_CHUNKS, 0)},
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
            {k: (SGRAF_CHUNKS, 0) for k in ("sgraf_align", "sgraf_align_bwd", "sgr", "sgr_bwd")},
            {"sgraf_dropout": 0.0},
            {"grad_rel": TRAIN_GRAD_REL_SGR, "floor": SGR_FLOOR,
             "kernel_rel": SGR_KERNEL_GRAD_REL, "plain_route": _sgraf_plain_chain}),
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
             {"vsrn_dec": (1, 0), "vsrn_dec_bwd": (1, 0)}, {"input_dropout_p": 0.0},
             {"grad_rel": TRAIN_GRAD_REL, "prepare": _vsrn_off_identity}),
    # the README's CAMERA command (`python train.py with CAMERA
    # data_name=f30k_precomp ...`): the CAMERA() overlay (embed 2048, 64 heads,
    # smry_k 12, smry_lamda 0.01, max_words 32, drop 0, lr 1e-4) with BERT-base
    # over the split's tiny vocabulary, batch 128, clip 2.0, fp32.  Both
    # towers' AGSA layers launch the forward and backward kernels once a step
    # each; validation encodes through the forward kernel, once a tower a
    # batch.  The witness against a float64 CPU copy and against the card's
    # plain AGSA pair
    "camera": ("CAMERA f30k training configuration",
               ("CAMERA", "bert_path={root}"), SAF_TRAIN_STEPS, SAF_TRAIN_VAL_STEP, 6,
               ("agsa_attn", "agsa_attn_bwd"), {"agsa_attn": (2, 2), "agsa_attn_bwd": (2, 0)},
               {}, {"exact": ("txt_enc.fc1", "img_enc.mvs.convs_dilate."),
                    "kernel_rel": CAMERA_KERNEL_GRAD_REL, "plain_route": _agsa_plain_route}),
    # VSE++'s f30k_precomp command (fartashf/vsepp README: --max_violation,
    # batch 128, lr 2e-4, embed 1024, word_dim 300) over a flat split (one
    # 4096-d vector an image), fp32: the GRU kernels once a step each, the
    # forward once a validation batch
    "vsepp": ("VSE++ f30k_precomp training configuration",
              ("VSE_PP", "max_violation=True", "batch_size=128", "learning_rate=2e-4",
               "embed_size=1024", "word_dim=300"), SAF_TRAIN_STEPS, SAF_TRAIN_VAL_STEP, 7,
              ("gru", "gru_bwd"), {"gru": (1, 1), "gru_bwd": (1, 0)}, {},
              {"grad_rel": TRAIN_GRAD_REL}),
    # the SAEM() overlay (batch 64, lr 1e-4, final_dims 256, the cnn text head
    # and the trans image branch) with BERT-base, frozen, over the split's
    # tiny vocabulary, fp32: no kernel.  The witness with every dropout at 0
    "saem": ("SAEM f30k training configuration", ("SAEM", "bert_path={root}"),
             SAF_TRAIN_STEPS, SAF_TRAIN_VAL_STEP, 8, (), {}, {},
             {"grad_rel": TRAIN_GRAD_REL, "prepare": _no_dropout}),
    # train_bf16 (itrx's make_train_step(compute_dtype="bfloat16")): the same
    # commands with the forward and backward in bf16 on fp32 masters; the
    # witness is _bf16_step_witness.  VSRN's runs the GRU pair at H 2048 and
    # the decoder pair in their bf16 modes
    "vsrn_bf16": ("VSRN f30k training configuration, train_bf16",
                  ("VSRN", "max_violation=True", "lr_update=10", "max_len=60",
                   "train_bf16=True"), SAF_TRAIN_STEPS, SAF_TRAIN_VAL_STEP, 9,
                  ("gru", "gru_bwd", "vsrn_dec", "vsrn_dec_bwd"),
                  {"vsrn_dec": (1, 0), "vsrn_dec_bwd": (1, 0)}, {"input_dropout_p": 0.0},
                  {"prepare": _vsrn_off_identity}),
    "scan_bf16": ("SCAN f30k t2i training configuration, train_bf16",
                  ("SCAN", "bi_gru=True", "max_violation=True", "train_bf16=True"),
                  SAF_TRAIN_STEPS, SAF_TRAIN_VAL_STEP, 10, ("gru", "gru_bwd", "xattn"), {}, {},
                  {}),
    # the AGSA pair in its bf16 mode (the backward's three-launch FMA
    # design), twice a step each
    "camera_bf16": ("CAMERA f30k training configuration, train_bf16",
                    ("CAMERA", "bert_path={root}", "train_bf16=True"), SAF_TRAIN_STEPS,
                    SAF_TRAIN_VAL_STEP, 11, ("agsa_attn", "agsa_attn_bwd"),
                    {"agsa_attn": (2, 2), "agsa_attn_bwd": (2, 0)}, {}, {}),
}


def _frozen_check(cfg: dict, state) -> dict:
    """Parameters that take no gradient (CAMERA's BERT) leave fit as the seed
    drew them, bit for bit, outside the optimizer and with no Adam state.
    Returns their counts."""
    model = state.model
    frozen = {k: p for k, p in model.named_parameters() if not p.requires_grad}
    trained = [p for p in model.parameters() if p.requires_grad]
    in_opt = [p for group in state.optimizer.param_groups for p in group["params"]]
    if any(p in state.optimizer.state for p in frozen.values()) or any(
            not p.requires_grad for p in in_opt):
        raise AssertionError("the optimizer holds a frozen parameter")
    if frozen:
        seeded = dict(get_model(cfg, device=DEV, generator=torch.Generator().manual_seed(
            cfg["seed"])).named_parameters())
        changed = [k for k, p in frozen.items() if not torch.equal(p, seeded[k])]
        if changed:
            raise AssertionError(f"fit changed frozen parameters: {changed[:4]}")
        del seeded
    log(f"  frozen parameters unchanged, without Adam state: {len(frozen)} tensors "
        f"({sum(p.numel() for p in frozen.values())} values); Adam state for "
        f"{len(trained)} trained tensors")
    return {"frozen_tensors": len(frozen), "trained_tensors": len(trained)}


def synthetic_split(root: str, n_images: int, img_dim: int, splits: tuple, seed: int,
                    flat: bool = False) -> None:
    """A synthetic f30k_precomp split under `root`: 36 regions of img_dim
    features an image, or with `flat` one vector an image (VSE++'s
    precomputed features), the mean of 12 regions, written as
    {split}_ims.npy (as tests/test_e2e.py makes it)."""
    d = os.path.join(root, "f30k_precomp")
    generate(d, n_images=n_images, img_dim=img_dim, n_regions=12 if flat else 36,
             splits=splits, seed=seed, n_concepts_range=(2, 10))
    if flat:
        for split in splits:
            path = os.path.join(d, f"{split}_ims.npy")
            np.save(path, np.load(path).mean(axis=1))


def phase_train(root: str, card: str, name: str) -> dict:
    """A training slice at full width through fit: one epoch of a synthetic
    split, one validation and checkpoint mid-epoch and one at its end; the
    first-step witness, the counters, finite and falling losses,
    evalrank_single reproducing best_rsum, then the median step time, peak
    memory and a profile of 3 steps."""
    (title, method, steps, val_step, data_seed, used, counts, witness_cfg,
     limits) = TRAIN_SLICES[name]
    log(f"training slice: {title} at full width")
    t0 = time.perf_counter()
    cfg = parse_cli(
        ["with", *(m.format(root=root) for m in method), "data_name=f30k_precomp",
         f"data_path={root}",
         f"vocab_path={os.path.join(REPO, 'itrx', 'vocab')}", "vocab_type=json",
         "num_epochs=1", f"val_step={val_step}", "log_step=1", f"save_path={root}/runs",
         "seed=0"],
    )
    synthetic_split(root, steps * cfg["batch_size"] // 5, cfg["img_dim"], ("train", "dev"),
                    data_seed, flat=cfg["name"] == "VSE_PP")
    write_tiny_bert_vocab(os.path.join(root, "vocab.txt"))  # CAMERA's and SAEM's BERT
    train_ds, val_ds, vocab_size = get_loaders(cfg)
    cfg["vocab_size"] = vocab_size
    log(f"  data set-up: {time.perf_counter() - t0:.1f} s ({len(train_ds)} train / "
        f"{len(val_ds)} dev captions, vocab {vocab_size}); batch {cfg['batch_size']}, "
        f"embed {cfg['embed_size']}, word_dim {cfg['word_dim']}, img_dim {cfg['img_dim']}, "
        f"lr {cfg['learning_rate']}, clip {cfg['grad_clip']}, train_bf16 "
        f"{cfg['train_bf16']}, sim_bf16 {cfg['sim_bf16']}, sim_dim {cfg['sim_dim']}, "
        f"cap_chunk {cfg['cap_chunk']}")

    first = next(train_ds.train_batches(cfg["batch_size"], cfg["seed"], 0))
    if cfg["train_bf16"]:
        witness = _bf16_step_witness(dict(cfg, **witness_cfg), first, **limits)
    else:
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
    check_modes(launches, cfg["train_bf16"], f"{name}'s training path")
    if state.step != steps:
        raise AssertionError(f"fit ran {state.step} steps, expected {steps}")
    frozen = _frozen_check(cfg, state)
    if cfg["train_bf16"]:
        _masters_check(state)

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
    val_batches = len(rsums) * -(-len(val_ds) // cfg["batch_size"])
    for k, (a_step, a_batch) in counts.items():
        if launches[k] != a_step * steps + a_batch * val_batches:
            raise AssertionError(f"{k}: {launches[k]} launches, expected {a_step} a step and "
                                 f"{a_batch} a validation batch ({val_batches})")

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
    step_fn = make_train_step(state, cfg["seed"],
                              torch.bfloat16 if cfg["train_bf16"] else None)
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
        "witness": witness, "profile": prof, "launches": launches, "frozen": frozen,
    }
    log(f"{name} training result: " + json.dumps(out))
    return out


# train_bf16 steps taken at full width without a fit: (the training slice
# whose command they run, the kernels their steps must launch)
BF16_QUICK = {"sgr": ("sgr", ("gru", "gru_bwd", "sgraf_align", "sgraf_align_bwd", "sgr",
                              "sgr_bwd")),
              "vsepp": ("vsepp", ("gru", "gru_bwd")), "saem": ("saem", ())}
BF16_QUICK_STEPS = 3


def phase_bf16_steps(root: str, card: str, name: str) -> dict:
    """BF16_QUICK_STEPS steps of make_train_step under train_bf16 on the card
    at the slice's full width (SGRAF-SGR with sim_bf16, VSE++, SAEM), their
    parity with `itrx` held in tests/test_torch_train_bf16.py: finite losses,
    the counters (every kernel of the path launched, no other), fp32 masters
    after them, and the median step."""
    slice_name, used = BF16_QUICK[name]
    title, method, _, _, data_seed = TRAIN_SLICES[slice_name][:5]
    log(f"train_bf16 steps: {title} at full width, {BF16_QUICK_STEPS} steps")
    cfg = parse_cli(
        ["with", *(m.format(root=root) for m in method), "train_bf16=True",
         "data_name=f30k_precomp", f"data_path={root}",
         f"vocab_path={os.path.join(REPO, 'itrx', 'vocab')}", "vocab_type=json",
         f"save_path={root}/runs", "seed=0"], make_dirs=False)
    synthetic_split(root, BF16_QUICK_STEPS * cfg["batch_size"] // 5 + 5, cfg["img_dim"],
                    ("train", "dev"), data_seed, flat=cfg["name"] == "VSE_PP")
    write_tiny_bert_vocab(os.path.join(root, "vocab.txt"))
    train_ds, _, vocab_size = get_loaders(cfg)
    cfg["vocab_size"] = vocab_size
    model = get_model(cfg, device=DEV, generator=torch.Generator().manual_seed(cfg["seed"]))
    state = create_train_state(model, cfg, BF16_QUICK_STEPS)
    step_fn = make_train_step(state, cfg["seed"], torch.bfloat16)
    batches = list(prefetch(train_ds.train_batches(cfg["batch_size"], cfg["seed"], 0), DEV))
    reset_counters()
    losses, times = [], []
    for b in batches[:BF16_QUICK_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step_fn(b, log=True)["Loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counters()
    log(f"  losses {losses}; launches {launches}; step s {times}")
    if len(losses) != BF16_QUICK_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train_bf16 {name}: losses {losses}")
    for k in COUNTERS:
        if (k in used) != (launches[k] > 0):
            raise AssertionError(f"train_bf16 {name}: {k} launched {launches[k]} times")
    check_modes(launches, True, f"train_bf16 {name}")
    _masters_check(state)
    return {"card": card, "losses": losses, "launches": launches, "step_seconds": times}


def main():
    card = phase_device()
    phase_build()
    g = torch.Generator().manual_seed(0)
    results = {"gru": phase_gru(g), "gru_bwd": phase_gru_bwd(g, shapes=GRU_BWD_SHAPES),
               "xattn": phase_xattn(g),
               "xattn_i2t": phase_xattn_i2t(g), "sgraf_eval_saf": phase_sgraf_eval_saf(g),
               "sgraf_eval_sgr": phase_sgraf_eval_sgr(g), "sgraf_align": phase_sgraf_align(g)}
    results["sgraf_align_bwd"] = align_bwd_result(results["sgraf_align"])
    results["sgr"] = phase_sgr(g)
    results["sgr_bwd"] = sgr_bwd_result(results["sgr"])
    results["vsrn_dec"] = phase_vsrn_dec(g)
    results["vsrn_dec_bwd"] = vsrn_bwd_result(results["vsrn_dec"])
    results["agsa_attn"] = phase_agsa(g)
    results["agsa_attn_bwd"] = agsa_bwd_result(results["agsa_attn"])
    # the bf16 modes of train_bf16's path, on inputs of their own seed (the
    # readings their limits were taken from)
    gb = torch.Generator().manual_seed(BF16_MODES_SEED)
    results["gru_bwd_bf16"] = phase_gru_bwd_bf16(gb)
    results["vsrn_dec_bf16"] = phase_vsrn_dec_bf16(gb)
    results["vsrn_dec_bwd_bf16"] = vsrn_bwd_result(results["vsrn_dec_bf16"])
    # the GRU kernels at VSRN's text width (H 2048, 61 slots; the region GRU is
    # the same recurrence over 36 steps): fp32, the streamed route, timed
    # beside cuDNN
    phase_gru_bwd(g, b=128, l=61, d=300, h=2048)
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
        phase_slice(data_root, card, "vsrn")
        new_slices = {"saem": phase_slice(data_root, card, "saem")[0],
                      "saem_rnn": phase_slice(data_root, card, "saem_rnn")[0]}
        phase_ensemble(data_root, data_root, card)
        phase_sgraf_ensemble(data_root, data_root, card, {"sgr": sgr_sims, "saf": saf_sims})
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_vsepp_") as root:
        # VSE++'s precomputed features: 1000 test images x one 4096-d vector
        synthetic_split(root, 4000, 4096, ("test",), 0, flat=True)
        new_slices["vsepp"] = phase_slice(root, card, "vsepp")[0]
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
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_train_camera_") as root:
        tr_cam = phase_train(root, card, "camera")
    new_train = {}
    for name in ("vsepp", "saem"):
        with tempfile.TemporaryDirectory(prefix=f"itrx_smoke_train_{name}_") as root:
            new_train[name] = phase_train(root, card, name)
    bf16_train = {}
    for name in ("vsrn_bf16", "scan_bf16", "camera_bf16"):
        with tempfile.TemporaryDirectory(prefix=f"itrx_smoke_train_{name}_") as root:
            bf16_train[name] = phase_train(root, card, name)
    for name in BF16_QUICK:
        with tempfile.TemporaryDirectory(prefix=f"itrx_smoke_bf16_{name}_") as root:
            phase_bf16_steps(root, card, name)
    for name, r in new_slices.items():
        log(f"{name} evaluation slice: encode {r['encode_seconds']:.4f} s, eval "
            f"{r['eval_seconds']:.5f} s, {r['pairs_per_sec']:.4g} pairs/s, idle share of "
            f"encode {r['profile_encode']['idle_share']}, gru launches "
            f"{r['launches']['gru']} ({card})")
    for name, r in {**new_train, **bf16_train}.items():
        log(f"{name} training slice: step {r['step_seconds_median']:.5f} s (median), "
            f"{r['samples_per_sec']:.1f} samples/s, fit {r['fit_seconds']:.2f} s, idle share "
            f"{r['profile']['idle_share']}, gru / gru_bwd launches {r['launches']['gru']} / "
            f"{r['launches']['gru_bwd']} ({card})")
    # launches: each kernel's count from the main path that runs it (SCAN's
    # training path for the GRU kernels and t2i validation, the i2t slice's
    # evaluate_split for xattn_i2t, the SAF and SGR slices' for their eval
    # kernels, SGRAF-SAF's training path for the alignment kernels,
    # SGRAF-SGR's for the reasoning kernels, VSRN's for the decoder kernels,
    # the CAMERA slice's evaluate_split for agsa_attn, CAMERA's training path
    # for agsa_attn_bwd)
    launches = dict(tr["launches"], xattn_i2t=i2t["launches"]["xattn_i2t"],
                    sgraf_eval_saf=saf["launches"]["sgraf_eval_saf"],
                    sgraf_eval_sgr=sgr["launches"]["sgraf_eval_sgr"],
                    sgraf_align=tr_saf["launches"]["sgraf_align"],
                    sgraf_align_bwd=tr_saf["launches"]["sgraf_align_bwd"],
                    sgr=tr_sgr["launches"]["sgr"], sgr_bwd=tr_sgr["launches"]["sgr_bwd"],
                    vsrn_dec=tr_vsrn["launches"]["vsrn_dec"],
                    vsrn_dec_bwd=tr_vsrn["launches"]["vsrn_dec_bwd"],
                    agsa_attn=cam["launches"]["agsa_attn"],
                    agsa_attn_bwd=tr_cam["launches"]["agsa_attn_bwd"],
                    # the bf16 modes from train_bf16's paths: SCAN's for the
                    # GRU adjoint (the shape its row is timed at), VSRN's for
                    # the decoder pair
                    gru_bwd_bf16=bf16_train["scan_bf16"]["launches"]["gru_bwd_bf16"],
                    vsrn_dec_bf16=bf16_train["vsrn_bf16"]["launches"]["vsrn_dec_bf16"],
                    vsrn_dec_bwd_bf16=bf16_train["vsrn_bf16"]["launches"]["vsrn_dec_bwd_bf16"])
    log(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"itrx_torch/csrc/{SOURCES[MODE_OF.get(name, name)]}",
            "replaces": REPLACES[MODE_OF.get(name, name)],
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
