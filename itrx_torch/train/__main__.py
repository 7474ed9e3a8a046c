"""Training CLI of the port, the surface of train.py:

    python -m itrx_torch.train with SCAN data_name=f30k_precomp data_path=/data \\
        bi_gru=True max_violation=True

It trains on cuda:0 and needs an NVIDIA GPU: with none it exits with an
error (there is no CPU fallback).
"""

from __future__ import annotations

import logging
import sys

from itrx.configs import parse_cli

from ..utils.cli import require_cuda
from .loop import fit


def main(argv) -> int:
    logging.basicConfig(format="%(asctime)s %(message)s", level=logging.INFO)
    device = require_cuda("itrx_torch.train")
    config = parse_cli(argv)
    print("".center(120, "-"))
    for i, (k, v) in enumerate(sorted(config.items())):
        print(f"{k}: {v}".center(40, " "), end="\n" if i % 3 == 2 else "")
    print()
    print("".center(120, "-"))
    _, best_rsum = fit(config, device=device)
    print(f"Training done. best rsum = {best_rsum:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
