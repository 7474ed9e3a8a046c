#!/usr/bin/env python3
"""Drive the PyTorch port of itrx once on an NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA (there is no CPU fallback), prints the card's name
   and power limit, and turns TF32 off so fp32 comparisons are real fp32;
2. build: compiles the kernels of itrx_torch/csrc with nvcc for sm_90a;
3. kernel vs plain: each kernel's wrapper against its plain PyTorch version
   on the same inputs on the card, at the main path's widths and at ragged
   sizes, with stated tolerances, and each one's time beside the plain
   version's (CUDA events, after warm-up);
4. the slice at full width: SCAN t2i evaluation of an f30k-1K-shaped
   synthetic split (1000 images x 36 x 2048 regions, 5000 captions) through
   get_model -> evaluate_split (encode_data -> cal_sims -> cal_recall) with
   encode_bf16 and eval_bf16, weights from torch.Generator().manual_seed(0);
   the launch counters show that both kernels ran.  The phases are then
   timed one by one and must reproduce evaluate_split's ranks.  The witness:
   the bf16 kernel grid must match the plain fp32 grid on the same embeddings
   (max abs diff <= SLICE_MAX_DIFF) and rank like it (per-caption top-1
   agreement >= 0.95).

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from itrx.configs import parse_cli
from itrx.data.precomp import get_test_loader
from itrx.data.synthetic import generate
from itrx_torch.eval import engine, metrics
from itrx_torch.models import get_model
from itrx_torch.ops import kernels
from itrx_torch.ops.kernels.gru import gru_scan_fused
from itrx_torch.ops.kernels.xattn import xattn_t2i_fused, xattn_t2i_plain
from itrx_torch.ops.rnn import gru_scan

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
REPLACES = {
    "gru": "itrx/ops/pallas/gru.py:37 (_fwd_kernel)",
    "xattn": "itrx/ops/pallas/xattn.py:43 (_kernel)",
}


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


def phase_build():
    for name in ("gru", "xattn"):
        t0 = time.perf_counter()
        kernels.load(name)
        dt = time.perf_counter() - t0
        info = kernels.library_path(name).with_suffix(".log")
        log(f"build {name}: {dt:.2f} s (nvcc sm_90a, {kernels.library_path(name).name})")
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
    gru_scan_fused.launches = 0
    xattn_t2i_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = engine.evaluate_split(model, dataset, cfg, device=DEV)
    torch.cuda.synchronize()
    ev_first = time.perf_counter() - t0
    launches = {"gru": gru_scan_fused.launches, "xattn": xattn_t2i_fused.launches}
    log(f"  main path (evaluate_split) launches: {launches}")
    for k, n in launches.items():
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


def main():
    card = phase_device()
    phase_build()
    g = torch.Generator().manual_seed(0)
    results = {"gru": phase_gru(g), "xattn": phase_xattn(g)}
    with tempfile.TemporaryDirectory(prefix="itrx_smoke_") as data_root:
        sl = phase_slice(data_root, card)
    log(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"itrx_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sl["launches"][name],
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
