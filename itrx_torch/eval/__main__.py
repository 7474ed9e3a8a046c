"""Evaluation CLI of the port, the surface of test.py:

    python -m itrx_torch.eval single /path/to/model_best.pth.tar [--split dev] [--fold5] [--data_path P]
    python -m itrx_torch.eval ensemble CKPT1 CKPT2 [--split testall] [--fold5] [--data_path P]

It evaluates on cuda:0 and needs an NVIDIA GPU: with none it exits with an
error (there is no CPU fallback).
"""

from __future__ import annotations

import argparse

from ..utils.cli import require_cuda
from .engine import evalrank_ensemble, evalrank_single


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m itrx_torch.eval")
    ap.add_argument("mode", choices=["single", "ensemble"])
    ap.add_argument("model_path")
    ap.add_argument("model_path2", nargs="?", default=None)
    ap.add_argument("--split", default="test")
    ap.add_argument("--fold5", action="store_true")
    ap.add_argument("--data_path", default=None)
    args = ap.parse_args(argv)
    if args.mode == "ensemble" and not args.model_path2:
        ap.error("ensemble mode needs two checkpoint paths")
    device = require_cuda("itrx_torch.eval")
    if args.mode == "single":
        evalrank_single(args.model_path, data_path=args.data_path, split=args.split,
                        fold5=args.fold5, device=device)
    else:
        evalrank_ensemble(args.model_path, args.model_path2, data_path=args.data_path,
                          split=args.split, fold5=args.fold5, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
