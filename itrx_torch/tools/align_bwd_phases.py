"""Where the SGRAF alignment backward's region pass spends its time, on the card.

    python -m itrx_torch.tools.align_bwd_phases

Builds a copy of csrc/sgraf_align_bwd.cu with a timer (the SM's
%globaltimer, read by thread 0 of every block) at each phase boundary of
region_kernel, runs it through the wrapper at one SGRAF training chunk (32
captions x 128 images x 36 regions x 24 words x 1024, S 256), bf16 and
fp32 embeddings, and prints the microseconds a block spends, on average
over the blocks, in each phase: the A product and the softmax, GS (phase A),
the staging of GS and the Gram, the context-norm backward, the word-norm
backward to gA, M and the dimg fragments, and the slabs of dcap and dimg
(phase B).  The copy lives under build/align_bwd_phases/; the kernel the
port runs is not touched.  Needs a CUDA card and nvcc.
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

OUT = kernels.BUILD_DIR.parent / "align_bwd_phases"
MAX_BLOCKS = 1 << 14
TIMER = r'''
__device__ unsigned long long g_phase_at[%d][8];
__device__ __forceinline__ void phase_mark(int i) {
  if (threadIdx.x == 0 && blockIdx.x < %d) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    g_phase_at[blockIdx.x][i] = t;
  }
}
''' % (MAX_BLOCKS, MAX_BLOCKS)
PHASES = ("A product and softmax", "GS (phase A)", "GS out and the Gram", "context-norm backward",
          "word-norm backward to gA", "M and the dimg fragments", "dcap and dimg (phase B)")
# (marker in region_kernel, where the mark goes): mark i before phase i
MARKS = (
    ("  const float m = valid ? mask[(size_t)c * L + l] : 0.0f;\n", "after"),
    ("  __syncthreads();  // the A tiles are read: the stage region is free\n", "after"),
    ("  // ---- the context-norm and softmax backward", "before"),
    ("  {\n    float sv[kR], gv[kR];", "before"),
    ("  // ---- the word-norm backward", "before"),
    ("  // ---- -M[p][r][r']", "before"),
    ("  // ---- phase B: per slab of D", "before"),
    ("refilled\n  }\n}\n", "end"),
)


def build() -> ctypes.CDLL:
    """csrc/sgraf_align_bwd.cu with the timers, compiled as the port compiles it."""
    src = (kernels.CSRC / "sgraf_align_bwd.cu").read_text()
    src = src.replace('#include "sgraf_nodes_mma.cuh"',
                      f'#include "{kernels.CSRC / "sgraf_nodes_mma.cuh"}"\n{TIMER}', 1)
    src = src.replace('#include "sgraf_nodes.cuh"',
                      f'#include "{kernels.CSRC / "sgraf_nodes.cuh"}"', 1)
    for i, (old, where) in enumerate(MARKS):
        if src.count(old) != 1:
            raise RuntimeError(f"sgraf_align_bwd.cu changed: no phase marker {old[:60]!r}")
        mark = f"  phase_mark({i});\n"
        new = {"after": old + mark, "before": mark + old,
               "end": "refilled\n  }\n" + mark + "}\n"}[where]
        src = src.replace(old, new, 1)
    src = src.replace('extern "C" {', 'extern "C" {\nint itrx_align_bwd_phases(void* out) {\n'
                      '  return (int)cudaMemcpyFromSymbol(out, g_phase_at, sizeof(g_phase_at));\n'
                      '}\n', 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "sgraf_align_bwd.cu").write_text(src)
    lib = OUT / "sgraf_align_bwd.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                           str(OUT / "sgraf_align_bwd.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the timed sgraf_align_bwd.cu:\n{proc.stderr}")
    out = ctypes.CDLL(str(lib))
    out.itrx_cuda_error_string.argtypes = [ctypes.c_int]
    out.itrx_cuda_error_string.restype = ctypes.c_char_p
    return out


def phases(lib: ctypes.CDLL, n_blocks: int) -> list:
    """Mean microseconds a block of the last launch spends in each phase."""
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * 8))()
    torch.cuda.synchronize()
    kernels.check(lib, "itrx_align_bwd_phases", lib.itrx_align_bwd_phases(ctypes.byref(buf)))
    sums = [0.0] * len(PHASES)
    for b in range(n_blocks):
        at = buf[8 * b:8 * b + 8]
        for i in range(len(PHASES)):
            sums[i] += (at[i + 1] - at[i]) / 1e3
    return [s / n_blocks for s in sums]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("align_bwd_phases: needs a CUDA card")
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
    cot = torch.randn(nc, ni, l, s, generator=g) * mask[:, None, :, None]
    cpb = min(ka.BLOCK_WORDS // l, ka.MAX_CAPS)
    n_blocks = -(-nc // cpb) * -(-ni // 2)
    for dt in (torch.bfloat16, torch.float32):
        x = dict(cap=cap.to(dev, dt), mask=mask.to(dev), img=img.to(dev, dt), w=w.to(dev),
                 b=b.to(dev))
        for _ in range(3):
            ka.sgraf_align_bwd_fused(**x, g=cot.to(dev, dt))
        us = phases(lib, n_blocks)
        print(json.dumps({"kernel": "region_kernel", "shape": [nc, ni, 36, l, d, s],
                          "mode": str(dt)[6:], "blocks": n_blocks,
                          "us_a_block": {k: round(v, 2) for k, v in zip(PHASES, us)},
                          "us_a_block_total": round(sum(us), 2)}), flush=True)


if __name__ == "__main__":
    main()
