"""Where the SGRAF alignment forward spends its time, on the card.

    python -m itrx_torch.tools.align_fwd_phases

Builds a copy of csrc/sgraf_align.cu with a timer (the SM's %globaltimer,
read by thread 0 of every block) at each phase boundary of
sgraf_align_kernel, runs it through the wrapper at one SGRAF training chunk
(32 captions x 128 images x 36 regions x 24 words x 1024, S 256), bf16 and
fp32 embeddings, and prints the microseconds a block spends, on average over
the blocks, in each phase: the zero rows of its masked words, the node
assembly (the A product and the region softmax), the split of the softmax
weights, and the projection tiles, cut into their products (the context on
mma.sync and the projection on wgmma, with the slabs' staging) and their
epilogues (the rows out of the registers, the norms and the stores).  The
copy lives under build/align_fwd_phases/; the kernel the port runs is not
touched.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys

import torch

from ..ops import kernels
from ..ops.kernels import sgraf_align as ka

OUT = kernels.BUILD_DIR.parent / "align_fwd_phases"
MAX_BLOCKS = 1 << 14
TIMER = r'''
__device__ unsigned long long g_phase_at[%d][8];
__device__ __forceinline__ unsigned long long phase_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void phase_store(int i, unsigned long long v) {
  if (threadIdx.x == 0 && blockIdx.x < %d) g_phase_at[blockIdx.x][i] = v;
}
__device__ __forceinline__ void phase_mark(int i) { phase_store(i, phase_now()); }
''' % (MAX_BLOCKS, MAX_BLOCKS)
PHASES = ("zero rows of masked words", "A product and softmax", "softmax split",
          "tiles: context and projection products", "tiles: epilogue")
# (marker in sgraf_align_kernel, its replacement): marks 0-4 at the phase
# boundaries, slot 5 the epilogues' sum over the tiles
EDITS = (
    ("  // the zero rows of the block's masked words",
     "  phase_mark(0);\n  // the zero rows of the block's masked words"),
    ("  init_weight_bars();\n", "  phase_mark(1);\n  init_weight_bars();\n"),
    ("  split_softmax(nd);\n",
     "  phase_mark(2);\n  split_softmax(nd);\n  phase_mark(3);\n"
     "  unsigned long long phase_epi = 0;\n"),
    ("    tile_out(acc, rg, prod.nrows,",
     "    const unsigned long long phase_te = phase_now();\n    tile_out(acc, rg, prod.nrows,"),
    ("    });\n  }\n}\n\ntemplate <typename T>\nint run(",
     "    });\n    phase_epi += phase_now() - phase_te;\n  }\n  phase_mark(4);\n"
     "  phase_store(5, phase_epi);\n}\n\ntemplate <typename T>\nint run("),
)


def build() -> ctypes.CDLL:
    """csrc/sgraf_align.cu with the timers, compiled as the port compiles it."""
    src = (kernels.CSRC / "sgraf_align.cu").read_text()
    src = src.replace('#include "sgraf_nodes_mma.cuh"',
                      f'#include "{kernels.CSRC / "sgraf_nodes_mma.cuh"}"\n{TIMER}', 1)
    src = src.replace('#include "sgraf_nodes.cuh"',
                      f'#include "{kernels.CSRC / "sgraf_nodes.cuh"}"', 1)
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"sgraf_align.cu changed: no phase marker {old[:60]!r}")
        src = src.replace(old, new, 1)
    src = src.replace('extern "C" {', 'extern "C" {\nint itrx_align_fwd_phases(void* out) {\n'
                      '  return (int)cudaMemcpyFromSymbol(out, g_phase_at, sizeof(g_phase_at));\n'
                      '}\n', 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "sgraf_align.cu").write_text(src)
    lib = OUT / "sgraf_align.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                           str(OUT / "sgraf_align.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the timed sgraf_align.cu:\n{proc.stderr}")
    out = ctypes.CDLL(str(lib))
    out.itrx_cuda_error_string.argtypes = [ctypes.c_int]
    out.itrx_cuda_error_string.restype = ctypes.c_char_p
    return out


def phases(lib: ctypes.CDLL, n_blocks: int) -> list:
    """Mean microseconds a block of the last launch spends in each phase."""
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * 8))()
    torch.cuda.synchronize()
    kernels.check(lib, "itrx_align_fwd_phases", lib.itrx_align_fwd_phases(ctypes.byref(buf)))
    sums = [0.0] * len(PHASES)
    for b in range(n_blocks):
        at = buf[8 * b:8 * b + 8]
        us = [(at[i + 1] - at[i]) / 1e3 for i in range(3)]
        us += [(at[4] - at[3] - at[5]) / 1e3, at[5] / 1e3]
        sums = [s + u for s, u in zip(sums, us)]
    return [s / n_blocks for s in sums]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("align_fwd_phases: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    lib = build()
    ka.load = lambda name: lib  # the wrapper launches the timed copy
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    nc, ni, l, d, s = 32, 128, 24, 1024, 256
    img = torch.randn(ni, 36, d, generator=g)
    img = img / img.norm(dim=-1, keepdim=True)
    lengths = torch.randint(2, l + 1, (nc,), generator=g)
    lengths[0] = 1
    mask = (torch.arange(l)[None] < lengths[:, None]).float()
    cap = torch.tanh(torch.randn(nc, l, d, generator=g) * 0.5) * mask[..., None]
    r = math.sqrt(6.0 / (d + s))
    w = (torch.rand(s, d, generator=g) * 2 - 1) * r
    b = (torch.rand(s, generator=g) * 2 - 1) * 0.05
    cpb = min(ka.BLOCK_WORDS // l, ka.MAX_CAPS)
    n_blocks = -(-nc // cpb) * -(-ni // 2)
    for dt in (torch.bfloat16, torch.float32):
        x = dict(cap=cap.to(dev, dt), mask=mask.to(dev), img=img.to(dev, dt), w=w.to(dev),
                 b=b.to(dev))
        with torch.no_grad():
            for _ in range(3):
                ka.sgraf_align_fused(**x)
        us = phases(lib, n_blocks)
        print(json.dumps({"kernel": "sgraf_align_kernel", "shape": [nc, ni, 36, l, d, s],
                          "mode": str(dt)[6:], "blocks": n_blocks,
                          "us_a_block": {k: round(v, 2) for k, v in zip(PHASES, us)},
                          "us_a_block_total": round(sum(us), 2)}), flush=True)


if __name__ == "__main__":
    main()
