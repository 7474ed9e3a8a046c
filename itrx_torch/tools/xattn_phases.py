"""Where the two SCAN score-grid kernels spend their time, on the card.

    python -m itrx_torch.tools.xattn_phases [--define NAME[=VALUE] ...]
    python -m itrx_torch.tools.xattn_phases --worst

Builds csrc/xattn.cu (t2i) and csrc/xattn_i2t.cu (i2t) three times each, as
the port builds them and with two `-D` cuts: ITRX_XATTN_PRODUCT_ONLY (the A
product alone, one of its values written so that it stays live) and
ITRX_XATTN_NO_AGG (the product and the chain, without the aggregation over
words or regions).  Each build runs through the wrapper at 64 images x 320
captions x 36 regions x 24 words x 1024 (the chip_smoke timing shape; t2i
LogSumExp at lambda_softmax 9, i2t Mean at 4), bf16 and fp32 embeddings, and
is timed with CUDA events (the median of 5 runs of 20 calls).  Printed per
direction and mode: each build's ms, the phases as differences (product;
chain = NO_AGG - PRODUCT_ONLY; aggregation = full - NO_AGG), and the same in
microseconds a work unit spends (`xattn.plan`: ms x slots / units).
`--define` adds a macro to every build.  The variants live under
build/itrx_torch_kernels/ beside the port's build; the kernel the port runs
is not touched.

`--worst` replays chip_smoke.py's generator through the phases before its
xattn check (run from the repository's root), draws the check's first t2i
shape in fp32, and prints for the pair where the kernel and the plain grid
differ most: kernel - plain, plain - exact and kernel - exact (exact: the
chain written out in float64, `t2i_pair_exact`), and the pair's score over 8 random
orders of an fp32 sum of A's products, minus exact.  Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from ..ops.kernels import xattn

PRODUCT_ONLY = ("ITRX_XATTN_PRODUCT_ONLY",)
NO_AGG = ("ITRX_XATTN_NO_AGG",)
SHAPE = (64, 320, 24, 1024)


class _Count:
    launches = 0


def _ms(fn, reps: int = 20, runs: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def inputs(ni: int, nc: int, l: int, d: int, seed: int = 0):
    """Embeddings as chip_smoke.py::_xattn_inputs makes them: unit regions,
    tanh captions of 2..l words (one of a single word), on the card."""
    g = torch.Generator().manual_seed(seed)
    img = torch.randn(ni, 36, d, generator=g)
    img = img / img.norm(dim=-1, keepdim=True)
    lengths = torch.randint(2, l + 1, (nc,), generator=g)
    lengths[0] = 1
    mask = (torch.arange(l)[None] < lengths[:, None]).float()
    cap = torch.tanh(torch.randn(nc, l, d, generator=g) * 0.5) * mask[..., None]
    dev = torch.device("cuda", 0)
    return img.to(dev), cap.to(dev), mask.to(dev)


def t2i_pair_exact(img, cap, mask, lambda_softmax=9.0, lambda_lse=6.0) -> float:
    """One (image, caption) t2i LogSumExp score in float64: img (36, D), cap
    (L, D), mask (L,)."""
    img, cap, mask = img.double(), cap.double(), mask.double()
    a = img @ cap.T
    h = torch.where(a > 0, a, 0.1 * a) * mask[None]
    attn = h / (torch.sqrt(torch.clamp((h * h).sum(1, keepdim=True), min=1e-16)) + 1e-8)
    s = torch.softmax(lambda_softmax * attn, dim=0)
    ctx = (s * ((img @ img.T) @ s)).sum(0)
    row = (s * a).sum(0) / torch.clamp(
        torch.sqrt(torch.clamp(ctx, min=1e-16)) * torch.sqrt((cap * cap).sum(1)), min=1e-8)
    return float(torch.log((mask * torch.exp(lambda_lse * row)).sum()) / lambda_lse)


def worst_pair() -> None:
    """chip_smoke.py's first fp32 t2i check, its worst pair against exact."""
    import chip_smoke as cs

    cs.phase_device()
    g = torch.Generator().manual_seed(0)
    cs.phase_gru(g)
    cs.phase_gru_bwd(g, shapes=cs.GRU_BWD_SHAPES)
    img, cap, mask = cs._xattn_inputs(g, 64, 320, 24)
    got, want = xattn.xattn_t2i_fused(img, cap, mask), xattn.xattn_t2i_plain(img, cap, mask)
    i, c = divmod(int((got - want).abs().argmax()), got.shape[1])
    im, ca, ma = img[i:i + 1], cap[c:c + 1], mask[c:c + 1]
    exact = t2i_pair_exact(im[0], ca[0], ma[0])
    orders = []
    gen = torch.Generator().manual_seed(1)
    for _ in range(8):
        perm = torch.randperm(im.shape[-1], generator=gen).to(im.device)
        a = torch.zeros(1, 1, 36, ca.shape[1], device=im.device)
        for k in perm:  # A's products summed one by one in fp32, in this order
            a += im[0, :, k][None, None, :, None] * ca[0, :, k][None, None, None, :]
        einsum = torch.einsum
        torch.einsum = lambda spec, *ops, _a=a: _a if spec == "ird,cld->icrl" else einsum(spec, *ops)
        try:
            orders.append(float(xattn.xattn_t2i_plain(im, ca, ma)) - exact)
        finally:
            torch.einsum = einsum
    print(json.dumps({"pair": [i, c], "words": int(ma.sum()),
                      "kernel_minus_plain": float(got[i, c] - want[i, c]),
                      "plain_minus_exact": float(want[i, c]) - exact,
                      "kernel_minus_exact": float(got[i, c]) - exact,
                      "fp32_orders_minus_exact": orders}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--worst", action="store_true")
    args = ap.parse_args()
    extra = tuple(args.define)
    if not torch.cuda.is_available():
        sys.exit("xattn_phases: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.worst:
        worst_pair()
        return
    ni, nc, l, d = SHAPE
    img, cap, mask = inputs(ni, nc, l, d)
    runs = {"t2i": (xattn.t2i_operands, dict(lambda_lse=6.0, lambda_softmax=9.0, agg_mean=False)),
            "i2t": (xattn.i2t_operands, dict(lambda_lse=6.0, lambda_softmax=4.0, agg_mean=True))}
    for direction, (operands, kw) in runs.items():
        for dt in (torch.bfloat16, torch.float32):
            ops = operands(img.to(dt), cap.to(dt), mask)
            ms = {}
            for name, defines in (("full", ()), ("no_agg", NO_AGG),
                                  ("product_only", PRODUCT_ONLY)):
                ms[name] = _ms(lambda: xattn._launch(
                    direction, _Count, *ops, kw["lambda_lse"], kw["lambda_softmax"],
                    kw["agg_mean"], defines=extra + defines))
            phase_ms = {"product": ms["product_only"],
                        "chain": ms["no_agg"] - ms["product_only"],
                        "aggregation": ms["full"] - ms["no_agg"]}
            p = xattn.plan(ni, nc, l, dt)
            print(json.dumps({
                "kernel": direction, "shape": [ni, nc, 36, l, d], "mode": str(dt)[6:],
                "defines": list(extra),
                "ms": {k: round(v, 4) for k, v in ms.items()},
                "phase_ms": {k: round(v, 4) for k, v in phase_ms.items()},
                "units": p["units"], "slots": p["slots"],
                "us_a_unit": {k: round(v * 1e3 * p["slots"] / p["units"], 2)
                              for k, v in phase_ms.items()},
            }), flush=True)


if __name__ == "__main__":
    main()
