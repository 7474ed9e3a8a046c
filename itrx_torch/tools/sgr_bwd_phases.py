"""Where the SGR reasoning backward's edge pass spends its time, on the card.

    python -m itrx_torch.tools.sgr_bwd_phases

Builds a copy of csrc/sgr_bwd.cu with a timer (the SM's %globaltimer, read
by thread 0 of every block) at each phase boundary of edge_kernel's batch
loop, runs it through the wrapper at one SGRAF-SGR training chunk (4096
pairs x 25 nodes, ragged 1-24 words, S 256, sgr_step 3; fp32 nodes), and
prints the microseconds a block spends, on average over the blocks and
summed over its batches and the three steps, in each phase: the batch's
staging (the rows by cp.async, the row tables), the units and X . v, the
query rows, the column sums, and the key rows; with the batches and rows a
block takes.  The copy lives under build/sgr_bwd_phases/; the kernel the
port runs is not touched.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import kernels
from ..ops.kernels import sgr as ks

OUT = kernels.BUILD_DIR.parent / "sgr_bwd_phases"
MAX_BLOCKS = 1 << 12
PHASES = ("staging", "units and X . v", "query rows", "column sums", "key rows")
TIMER = r'''
__device__ unsigned long long g_phase_ns[%d][8];
__device__ __forceinline__ unsigned long long phase_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void phase_add(int i, unsigned long long& since) {
  if (threadIdx.x == 0 && blockIdx.x < %d) {
    const unsigned long long t = phase_now();
    g_phase_ns[blockIdx.x][i] += t - since;
    since = t;
  }
}
''' % (MAX_BLOCKS, MAX_BLOCKS)
# (marker in edge_kernel, the code put after it)
MARKS = (
    ("  const Row8 vr = load_row(v, S);\n  for (int q0 = p0; q0 < p1;) {\n",
     "    unsigned long long since = phase_now();\n"),
    ('    asm volatile("cp.async.wait_group 0;\\n" ::);\n    __syncthreads();\n',
     "    phase_add(0, since);\n"),
    ("    __syncthreads();\n    const int nu = n_units;\n", "    phase_add(1, since);\n"),
    ("    __syncthreads();\n    // the key side: column sums of g_e, then per unit of key rows\n",
     "    phase_add(2, since);\n"),
    ("      col[rows[r0 + b]] = c;\n    }\n    __syncthreads();\n", "    phase_add(3, since);\n"),
    ("    __syncthreads();  // the next batch restages the rows\n",
     "    phase_add(4, since);\n"
     "    if (threadIdx.x == 0 && blockIdx.x < %d) {\n"
     "      g_phase_ns[blockIdx.x][5] += 1;\n"
     "      g_phase_ns[blockIdx.x][6] += R;\n"
     "    }\n" % MAX_BLOCKS),
)


def build(source: str = "sgr_bwd.cu", marks=MARKS, out: Path = OUT) -> ctypes.CDLL:
    """csrc/<source> with the timers put in after each marker of `marks`,
    compiled as the port compiles it into `out`; the library's
    itrx_phases(buf, zero) zeroes the timers (zero != 0) or copies them out."""
    src = (kernels.CSRC / source).read_text()
    for name in ("sgr_rows.cuh", "sgraf_nodes_mma.cuh"):
        src = src.replace(f'#include "{name}"', f'#include "{kernels.CSRC / name}"', 1)
    src = src.replace("namespace {\n", TIMER + "\nnamespace {\n", 1)
    for old, add in marks:
        if src.count(old) != 1:
            raise RuntimeError(f"{source} changed: no phase marker {old[:60]!r}")
        src = src.replace(old, old + add, 1)
    src = src.replace('extern "C" {', 'extern "C" {\nint itrx_phases(void* out, int zero) {\n'
                      '  if (zero) {\n'
                      '    static unsigned long long z[%d][8];\n'
                      '    return (int)cudaMemcpyToSymbol(g_phase_ns, z, sizeof(z));\n'
                      '  }\n'
                      '  return (int)cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(g_phase_ns));\n'
                      '}\n' % MAX_BLOCKS, 1)
    out.mkdir(parents=True, exist_ok=True)
    stem = source.removesuffix(".cu")
    (out / source).write_text(src)
    lib = out / f"{stem}.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                           str(out / source)], capture_output=True, text=True)
    (out / f"{stem}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the timed {source}:\n{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    so.itrx_cuda_error_string.argtypes = [ctypes.c_int]
    so.itrx_cuda_error_string.restype = ctypes.c_char_p
    return so


def read_timers(lib, run) -> list:
    """The timers of one call of `run` (zeroed before it): per block, its
    eight slots."""
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * 8))()
    kernels.check(lib, "itrx_phases", lib.itrx_phases(None, 1))
    run()
    torch.cuda.synchronize()
    kernels.check(lib, "itrx_phases", lib.itrx_phases(ctypes.byref(buf), 0))
    return [buf[8 * b:8 * b + 8] for b in range(MAX_BLOCKS)]


def inputs(dev, pairs=4096, words=24, steps=3, s=256, seed=0):
    """chip_smoke.py's reasoning inputs: ragged captions (1..words, one of
    one word and one of `words`), unit rows, the reference's init scale."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, words + 1, (pairs,), generator=g)
    lengths[0], lengths[-1] = 1, words
    mask = torch.cat([torch.ones(pairs, 1),
                      (torch.arange(words)[None] < lengths[:, None]).float()], dim=1)
    s0 = torch.randn(pairs, words + 1, s, generator=g)
    s0 = s0 / s0.norm(dim=-1, keepdim=True) * mask[..., None]
    r = math.sqrt(6.0 / (2 * s))
    x = dict(s0=s0, mask=mask)
    for k in ("q", "k", "g"):
        x[f"w{k}"] = (torch.rand(steps, s, s, generator=g) * 2 - 1) * r
        x[f"b{k}"] = (torch.rand(steps, s, generator=g) * 2 - 1) * 0.05
    cot = torch.randn(pairs, words + 1, s, generator=g) * mask[..., None]
    return {k: v.to(dev) for k, v in x.items()}, cot.to(dev)


def card_name() -> str:
    if not torch.cuda.is_available():
        sys.exit(f"{sys.argv[0]}: needs a CUDA card")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main() -> None:
    print(f"card: {card_name()}", flush=True)
    lib = build()
    # the wrapper launches the timed copy of sgr_bwd.cu (the port's own build
    # of the rest)
    ks.load = lambda name: lib if name == "sgr_bwd" else kernels.load(name)
    dev = torch.device("cuda", 0)
    x, cot = inputs(dev)
    _, outs = ks.sgr_reason_plain(**x)
    ks.sgr_reason_bwd_fused(**x, outs=outs, g=cot)
    blocks = [b for b in read_timers(lib, lambda: ks.sgr_reason_bwd_fused(**x, outs=outs, g=cot))
              if b[5]]
    n = len(blocks)
    us = [sum(b[i] for b in blocks) / n / 1e3 for i in range(len(PHASES))]
    print(json.dumps({"kernel": "edge_kernel", "shape": [4096, 25, 256, 3], "mode": "float32",
                      "blocks": n,
                      "batches_a_block": sum(b[5] for b in blocks) / n,
                      "rows_a_block": sum(b[6] for b in blocks) / n,
                      "us_a_block": {k: round(v, 2) for k, v in zip(PHASES, us)},
                      "us_a_block_total": round(sum(us), 2),
                      "us_slowest_block": round(max(sum(b[:5]) for b in blocks) / 1e3, 2)}),
          flush=True)


if __name__ == "__main__":
    main()
