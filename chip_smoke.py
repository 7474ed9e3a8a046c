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
   version's (CUDA events, after warm-up).  The GRU adjoint is held to
   autograd through the plain GRU (all five gradients, both directions);
4. the evaluation slice at full width: SCAN t2i evaluation of an f30k-1K-shaped
   synthetic split (1000 images x 36 x 2048 regions, 5000 captions) through
   get_model -> evaluate_split (encode_data -> cal_sims -> cal_recall) with
   encode_bf16 and eval_bf16, weights from torch.Generator().manual_seed(0);
   the launch counters show that both kernels ran.  The phases are then
   timed one by one and must reproduce evaluate_split's ranks.  The witness:
   the bf16 kernel grid must match the plain fp32 grid on the same embeddings
   (max abs diff <= SLICE_MAX_DIFF) and rank like it (per-caption top-1
   agreement >= 0.95);
5. the training slice at full width: SCAN's published f30k t2i training
   configuration (bi_gru, max_violation, batch 128, embed 1024, 36 x 2048
   regions, Adam 2e-4, clip 2.0, fp32) for one epoch of a synthetic split
   (50 steps) through itrx_torch.train.loop.fit, with one validation and
   checkpoint mid-epoch and one at its end.  The launch counters show that
   the GRU forward, the GRU adjoint and (in validation) xattn ran; every
   loss is finite and the loss falls; evalrank_single on model_best.pth.tar
   reproduces its best_rsum; the first step's loss and every gradient on the
   card match the same step on a CPU copy of the model (the plain path).
   Then the median step time and a profile of a few steps.

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from itrx.configs import parse_cli
from itrx.data.precomp import get_loaders, get_test_loader
from itrx.data.synthetic import generate
from itrx_torch.eval import engine, metrics
from itrx_torch.models import get_model
from itrx_torch.ops import kernels
from itrx_torch.ops.kernels import gru as kgru
from itrx_torch.ops.kernels.gru import gru_bwd_fused, gru_scan_fused
from itrx_torch.ops.kernels.xattn import xattn_t2i_fused, xattn_t2i_plain
from itrx_torch.ops.rnn import gru_bwd_plain, gru_fwd_plain, gru_scan
from itrx_torch.train.loop import fit, make_train_step, prefetch
from itrx_torch.utils.checkpoint import load_checkpoint

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
TRAIN_STEPS = 50  # one epoch of the synthetic train split at batch 128
TRAIN_VAL_STEP = 30  # one validation + checkpoint mid-epoch, one at the end
REPLACES = {
    "gru": "itrx/ops/pallas/gru.py:37 (_fwd_kernel)",
    "gru_bwd": "itrx/ops/pallas/gru.py:68 (_bwd_kernel)",
    "xattn": "itrx/ops/pallas/xattn.py:43 (_kernel)",
}
SOURCES = {"gru": "gru.cu", "gru_bwd": "gru_bwd.cu", "xattn": "xattn.cu"}
COUNTERS = {"gru": gru_scan_fused, "gru_bwd": gru_bwd_fused, "xattn": xattn_t2i_fused}


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
    log(f"  time bf16 (B=128, L=24, H=1024, one direction): kernel {res['ms']:.3f} ms, "
        f"plain {res['plain_ms']:.3f} ms; fp32: kernel {res['ms_fp32']:.3f} ms, "
        f"plain {res['plain_ms_fp32']:.3f} ms")
    return res


def phase_gru_bwd(g, b=128, l=48, d=300, h=1024) -> dict:
    """The GRU adjoint kernel (and the forward's residual mode) against the
    plain versions, at the training path's widths: B=128, L=48 (the caption
    length of scripts/train_bench.py), D=300, H=1024, fp32, ragged lengths
    1..48, both directions."""
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
    log(f"  time (one direction, B={b}, L={l}, H={h}, fp32): adjoint kernel "
        f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms; forward kernel with "
        f"residuals {res['fwd_residuals_ms']:.3f} ms, without {res['fwd_ms']:.3f} ms, "
        f"plain {res['fwd_plain_ms']:.3f} ms; forward+backward through autograd "
        f"(input projection included): kernels {res['fwd_bwd_ms']:.3f} ms, plain "
        f"{res['fwd_bwd_plain_ms']:.3f} ms")
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
    log(f"  time 64x320x36x24x1024 LSE bf16: kernel {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms; fp32: kernel {res['ms_fp32']:.3f} ms, plain "
        f"{res['plain_ms_fp32']:.3f} ms")
    return res


def plain_grid(imgs, caps, cap_mask, cfg) -> torch.Tensor:
    """The (Ni, Nc) grid through the plain version alone, in cal_sims' length
    buckets, tiled over captions so the attention tensor stays in budget."""
    ni, r = imgs.shape[:2]
    sims = torch.empty(ni, caps.shape[0], dtype=torch.float32, device=imgs.device)
    for in_bucket, b in engine.length_buckets(cap_mask, caps.shape[1]):
        idx = torch.from_numpy(in_bucket).to(imgs.device)
        tile = max(engine.PLAIN_ATTN_BYTES // (ni * r * b * 4), 1)
        for j0 in range(0, len(idx), tile):
            t = idx[j0:j0 + tile]
            sims[:, t] = xattn_t2i_plain(
                imgs, caps[t, :b], cap_mask[t, :b], agg_func=cfg["agg_func"],
                lambda_lse=cfg["lambda_lse"], lambda_softmax=cfg["lambda_softmax"],
            )
    return sims


def phase_slice(data_root: str, card: str) -> dict:
    log("slice: f30k-1K-shaped SCAN t2i evaluation")
    t0 = time.perf_counter()
    # bench.py's split: 4000 // 4 = 1000 test images x 36 x 2048, 5000 captions
    generate(os.path.join(data_root, "f30k_precomp"), n_images=4000, img_dim=2048,
             splits=("test",), seed=0, n_concepts_range=(2, 10))
    cfg = parse_cli(
        ["with", "SCAN", "data_name=f30k_precomp", f"data_path={data_root}",
         f"vocab_path={os.path.join(REPO, 'itrx', 'vocab')}", "vocab_type=json",
         "batch_size=128", "eval_bf16=True", "encode_bf16=True", "seed=0"],
        make_dirs=False,
    )
    dataset, vocab_size = get_test_loader("test", cfg)
    cfg["vocab_size"] = vocab_size
    model = get_model(cfg, device=DEV, generator=torch.Generator().manual_seed(cfg["seed"]))
    log(f"  data + model set-up: {time.perf_counter() - t0:.1f} s "
        f"({len(dataset)} captions, vocab {vocab_size}, bi_gru={cfg['bi_gru']})")

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
    if launches["gru_bwd"]:
        raise AssertionError("evaluation launched the GRU adjoint kernel")
    for k in ("gru", "xattn"):
        n = launches[k]
        if n <= 0:
            raise AssertionError(f"the main path never launched the {k} kernel")

    # the same path phase by phase, timed, with evaluate_split's dtypes
    bf16 = torch.bfloat16

    def encode():
        return engine.encode_data(model, dataset, cfg["batch_size"], device=DEV,
                                  compute_dtype=bf16, encode_dtype=bf16)

    def score(enc):
        imgs = enc["img"][:: dataset.im_div]
        sims = engine.cal_sims(model, imgs, enc["cap"], enc["cap_mask"],
                               compute_dtype=bf16, verbose=False)
        return sims, metrics.cal_recall(sims, cap_ratio=dataset.im_div, verbose=False)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = encode()
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
    shape = [ni, nc, int(imgs.shape[1]), int(enc["cap"].shape[1]), int(imgs.shape[2])]
    if (ni, nc) != (1000, 5000) or tuple(sims.shape) != (ni, nc):
        raise AssertionError(f"unexpected grid {tuple(sims.shape)} for shape {shape}")
    if not torch.isfinite(sims).all():
        raise AssertionError("non-finite similarity scores")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score(enc)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    eval_s = min(times)

    # witness: the plain fp32 path on the same (bf16-valued) embeddings
    t0 = time.perf_counter()
    sims32 = plain_grid(imgs.float(), enc["cap"].float(), enc["cap_mask"], cfg)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    top1 = sims.argmax(dim=0)
    agree = float((top1 == sims32.argmax(dim=0)).float().mean())
    distinct = int(torch.unique(top1).numel())
    err = float((sims - sims32).abs().max())
    res32 = metrics.cal_recall(sims32, cap_ratio=dataset.im_div, verbose=False)
    out = {
        "card": card,
        "shape [Ni, Nc, R, L, D]": shape,
        "evaluate_split_seconds_first": ev_first,
        "encode_seconds": enc_warm,
        "eval_seconds": eval_s,
        "eval_seconds_all": times,
        "pairs_per_sec": ni * nc / eval_s,
        "plain_fp32_sims_seconds": plain_s,
        "rsum_bf16_kernel": res["rsum"],
        "rsum_fp32_plain": res32["rsum"],
        "top1_agreement_bf16_kernel_vs_fp32_plain": agree,
        "max_abs_diff_bf16_kernel_vs_fp32_plain": err,
        "distinct_top1_images": distinct,
        "mean_per_caption_std_over_images": float(sims.std(dim=0).mean()),
        "launches": launches,
    }
    log("slice result: " + json.dumps(out))
    if distinct < 2:
        raise AssertionError("every caption ranks the same image first: the witness "
                             "cannot tell a right grid from a degenerate one")
    if not agree >= TOP1_MIN:
        raise AssertionError(f"bf16 kernel grid agrees with the fp32 plain grid on only "
                             f"{agree:.4f} of top-1 images (< {TOP1_MIN})")
    if not err <= SLICE_MAX_DIFF:
        raise AssertionError(f"bf16 kernel grid differs from the fp32 plain grid by "
                             f"{err} (> {SLICE_MAX_DIFF})")
    return out


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


def _first_step_witness(cfg, batch) -> dict:
    """The first training step's loss and gradients on the card (GRU kernels,
    plain attention) against the same step on a CPU copy (plain path
    throughout), from one seed's weights and one batch."""
    def step_on(dev):
        model = get_model(cfg, device=dev,
                          generator=torch.Generator().manual_seed(cfg["seed"]))
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, _ = model.loss(b, train=True)
        loss.backward()
        with torch.no_grad():
            e = model.embed(b)
            scores = model.similarity(e["img"], e["cap"], e["cap_mask"], train=True)
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        return loss.detach().cpu(), grads, scores.cpu()

    (lk, gk, sk), (lc, gc, sc) = step_on(DEV), step_on(torch.device("cpu"))
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
    grad_errs = {}
    for k in gc:
        grad_errs[k] = check_rel(f"first step grad {k} (card vs cpu)", gk[k], gc[k],
                                 TRAIN_GRAD_REL)
    return {"loss_card": float(lk), "loss_cpu": float(lc), "loss_rel_err": loss_err,
            "grad_rel_err_max": max(grad_errs.values()),
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


def phase_train(root: str, card: str) -> dict:
    log("training slice: SCAN f30k t2i training configuration at full width")
    t0 = time.perf_counter()
    n_images = TRAIN_STEPS * 128 // 5  # 5 captions per image
    generate(os.path.join(root, "f30k_precomp"), n_images=n_images, img_dim=2048,
             splits=("train", "dev"), seed=1, n_concepts_range=(2, 10))
    cfg = parse_cli(
        ["with", "SCAN", "data_name=f30k_precomp", f"data_path={root}",
         f"vocab_path={os.path.join(REPO, 'itrx', 'vocab')}", "vocab_type=json",
         "bi_gru=True", "max_violation=True", "num_epochs=1",
         f"val_step={TRAIN_VAL_STEP}", "log_step=1", f"save_path={root}/runs", "seed=0"],
    )
    train_ds, val_ds, vocab_size = get_loaders(cfg)
    cfg["vocab_size"] = vocab_size
    log(f"  data set-up: {time.perf_counter() - t0:.1f} s ({len(train_ds)} train / "
        f"{len(val_ds)} dev captions, vocab {vocab_size}); batch {cfg['batch_size']}, "
        f"embed {cfg['embed_size']}, word_dim {cfg['word_dim']}, img_dim {cfg['img_dim']}, "
        f"lr {cfg['learning_rate']}, clip {cfg['grad_clip']}, train_bf16 "
        f"{cfg['train_bf16']}")

    first = next(train_ds.train_batches(cfg["batch_size"], cfg["seed"], 0))
    witness = _first_step_witness(cfg, first)

    # the main path, counted: the port's train entry
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, best_rsum = fit(cfg, train_ds, val_ds, device=DEV)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counters()
    log(f"  main path (fit, 1 epoch) launches: {launches}; {fit_s:.2f} s")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the training path never launched the {k} kernel")
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"fit ran {state.step} steps, expected {TRAIN_STEPS}")

    losses, rsums = _losses_from_events(cfg["save_dir"])
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    first10, last10 = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    log(f"  loss: first {losses[0]:.4f}, mean of first 10 {first10:.4f}, of last 10 "
        f"{last10:.4f}; validation rsums {rsums}")
    if not last10 < first10:
        raise AssertionError(f"the loss did not fall: {first10} -> {last10}")
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
    step_fn = make_train_step(state)
    it = prefetch(train_ds.train_batches(cfg["batch_size"], cfg["seed"], 1), DEV)
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(next(it))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times[2:])
    prof = _profile_steps(step_fn, [next(it) for _ in range(3)])
    out = {
        "card": card,
        "steps": TRAIN_STEPS,
        "fit_seconds": fit_s,
        "step_seconds_median": step_s,
        "step_seconds": times,
        "samples_per_sec": cfg["batch_size"] / step_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_first": losses[0], "loss_mean_first10": first10,
        "loss_mean_last10": last10, "val_rsums": rsums, "best_rsum": best_rsum,
        "witness": witness, "profile": prof, "launches": launches,
    }
    log("training result: " + json.dumps(out))
    return out


def main():
    card = phase_device()
    phase_build()
    g = torch.Generator().manual_seed(0)
    results = {"gru": phase_gru(g), "gru_bwd": phase_gru_bwd(g), "xattn": phase_xattn(g)}
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_") as data_root:
        phase_slice(data_root, card)
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_train_") as root:
        tr = phase_train(root, card)
    log(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"itrx_torch/csrc/{SOURCES[name]}",
            "replaces": REPLACES[name],
            "launches": tr["launches"][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
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
