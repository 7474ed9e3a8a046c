"""How far an exactly summed bf16 AGSA chain lands from the plain one, on the card.

    python -m itrx_torch.tools.agsa_bf16_flips [--draws 3]

`chip_smoke.py` holds the AGSA kernels' bf16 outputs to agsa_attention_plain
within AGSA_BF16_REL, 2^-8 of the plain output's largest magnitude.  The
kernels the port runs in bf16 sum as the plain version's fp32 products do
(cuBLAS's sequential chains), so they agree with it bit for bit in the
forward and in dv.  This tool measures what a kernel that sums in any other
order would read: it runs agsa_attention_plain and agsa_attention_bwd_plain
on the card at both CAMERA towers' calls (B 128, 64 heads, N 36 or 32, d_k
32) in bf16, once as they are and once with every matrix product summed
exactly (float64, rounded once to fp32), and prints for the output and dq,
dk, dv the count of bf16 elements that differ, the largest difference over
max|plain| and whether it passes the limit, over `--draws` draws of
chip_smoke.py::_agsa_inputs' distributions.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import torch

from ..ops.kernels import agsa_attn as ka

LIMIT = 2.0 ** -8  # chip_smoke.py: AGSA_BF16_REL
SHAPES = {"img": (128, 64, 36, 32), "txt": (128, 64, 32, 32)}
MATMUL = torch.Tensor.__matmul__


@contextlib.contextmanager
def exact_products():
    """Every `a @ b` summed in float64 and rounded once to fp32 (the plain
    pair writes each of its products with @)."""
    torch.Tensor.__matmul__ = lambda a, b: torch.matmul(a.double(), b.double()).float()
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = MATMUL


def _apart(got, want) -> dict:
    d = (got.float() - want.float()).abs()
    rel = float(d.max() / want.float().abs().max())
    return {"rel": float(f"{rel:.3e}"), "differ": int((d > 0).sum()), "passes": rel <= LIMIT}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("agsa_bf16_flips: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    for seed in range(args.draws):
        g = torch.Generator().manual_seed(seed)
        for tower, (b, h, n, dk) in SHAPES.items():
            def u(*shape):
                return torch.empty(*shape).uniform_(-dk ** -0.5, dk ** -0.5, generator=g)

            x = [torch.randn(b, n, h * dk, generator=g) for _ in range(3)]
            x += [w for _ in range(4) for w in (u(dk, dk), u(dk))]
            x = [t.to(dev, torch.bfloat16) for t in x]
            go = torch.randn(b, n, h * dk, generator=g).to(dev, torch.bfloat16)
            with torch.no_grad():
                out = ka.agsa_attention_plain(*x, h)
                grads = ka.agsa_attention_bwd_plain(*x, go, h)[:3]
                with exact_products():
                    out_x = ka.agsa_attention_plain(*x, h)
                    grads_x = ka.agsa_attention_bwd_plain(*x, go, h)[:3]
            row = {"draw": seed, "tower": tower, "max_abs_out": float(out.float().abs().max()),
                   "out": _apart(out_x, out)}
            row.update({name: _apart(a, w) for name, a, w in zip(("dq", "dk", "dv"), grads_x, grads)})
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
