"""Where a step of the persistent GRU kernels goes, on the card.

    python -m itrx_torch.tools.gru_phases

Builds copies of csrc/gru.cu and csrc/gru_bwd.cu with a timer (the SM's
%globaltimer, read by thread 0 of block 0) at each phase boundary of the
step loop, runs them through the wrappers at the main paths' shapes and
prints, per call, the microseconds a step spends in the product (the
exchange read and the recurrent product), the epilogue (gate math, output
and residual writes, the loads of the inputs a step needs) and the grid
barrier, as block 0 sees them.  The copies live under build/gru_phases/; the kernels
the port runs are not touched.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..ops import kernels
from ..ops.kernels import gru as kgru
from ..ops.rnn import gru_fwd_plain

OUT = kernels.BUILD_DIR.parent / "gru_phases"
TIMER = r'''
__device__ unsigned long long g_phase_ns[4];
__device__ __forceinline__ unsigned long long phase_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''
START = "  unsigned long long phase_ns[4] = {0, 0, 0, 0}, phase_at = 0, phase_t;\n"
DUMP = ("  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
        "    for (int i = 0; i < 4; ++i) g_phase_ns[i] = phase_ns[i];\n  }\n")


def _tick(i: int) -> str:
    return ("    if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
            f"      phase_t = phase_now();\n      if (phase_at) phase_ns[{i}] += phase_t - phase_at;\n"
            "      phase_at = phase_t;\n    }\n")


# (marker in the source, its replacement): phase 0 the product, 1 the
# epilogue, 2 the barrier, 3 the loop's head
FWD_MARKS = (
    ("  for (int s = 0; s < L; ++s) {\n    const int t = reverse ? L - 1 - s : s;",
     START + "  for (int s = 0; s < L; ++s) {\n" + _tick(3)
     + "    const int t = reverse ? L - 1 - s : s;"),
    ("    float gxn[3][A][R], mn[R];", _tick(0) + "    float gxn[3][A][R], mn[R];"),
    ("      grid_sync(bar);\n", _tick(1) + "      grid_sync(bar);\n" + _tick(2)),
    ("  for (int a = 0; a < A; ++a) {\n    const int j = j0 + unit[a];\n#pragma unroll\n"
     "    for (int r = 0; r < R; ++r) {\n      const int row = rowg + kStep * r;\n"
     "      if (row < B && j < H) fin",
     DUMP + "  for (int a = 0; a < A; ++a) {\n    const int j = j0 + unit[a];\n#pragma unroll\n"
     "    for (int r = 0; r < R; ++r) {\n      const int row = rowg + kStep * r;\n"
     "      if (row < B && j < H) fin"),
)
BWD_MARKS = (
    ("  for (int s = 0; s < L; ++s) {\n    const int t = reverse ? s : L - 1 - s;",
     START + "  for (int s = 0; s < L; ++s) {\n" + _tick(3)
     + "    const int t = reverse ? s : L - 1 - s;"),
    ("    grid_sync(bar);\n", _tick(1) + "    grid_sync(bar);\n" + _tick(2)),
    ("    if (s + 1 < L) {\n      if (kPrefetch) {\n        cur = nxt;",
     _tick(0) + "    if (s + 1 < L) {\n      if (kPrefetch) {\n        cur = nxt;"),
    ("  for (int a = 0; a < A; ++a) {\n    const int k = j0 + unit[a];\n#pragma unroll\n"
     "    for (int r = 0; r < R; ++r) {\n      const int row = rowg + 4 * r;\n"
     "      if (row < B && k < H) gh0",
     DUMP + "  for (int a = 0; a < A; ++a) {\n    const int k = j0 + unit[a];\n#pragma unroll\n"
     "    for (int r = 0; r < R; ++r) {\n      const int row = rowg + 4 * r;\n"
     "      if (row < B && k < H) gh0"),
)


def build(name: str, marks) -> ctypes.CDLL:
    """csrc/<name>.cu with the timers, compiled as the port compiles it."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    src = src.replace('#include "gru_persistent.cuh"',
                      f'#include "{kernels.CSRC / "gru_persistent.cuh"}"\n{TIMER}')
    for old, new in marks:
        if old not in src:
            raise RuntimeError(f"{name}.cu changed: no phase marker {old[:60]!r}")
        src = src.replace(old, new, 1)
    src = src.replace('extern "C" {', 'extern "C" {\nint itrx_gru_phases(void* out) {\n'
                      '  return (int)cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(g_phase_ns));\n}\n',
                      1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(src)
    lib = OUT / f"{name}.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                           str(OUT / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the timed {name}.cu:\n{proc.stderr}")
    out = ctypes.CDLL(str(lib))
    out.itrx_cuda_error_string.argtypes = [ctypes.c_int]
    out.itrx_cuda_error_string.restype = ctypes.c_char_p
    return out


def phases(lib: ctypes.CDLL) -> list:
    buf = (ctypes.c_ulonglong * 4)()
    torch.cuda.synchronize()
    kernels.check(lib, "itrx_gru_phases", lib.itrx_gru_phases(ctypes.byref(buf)))
    return [v / 1e3 for v in buf]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("gru_phases: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"gru": build("gru", FWD_MARKS), "gru_bwd": build("gru_bwd", BWD_MARKS)}
    names = {"gru": "itrx_gru_fwd", "gru_bwd": "itrx_gru_bwd"}
    real = kgru._entry.__wrapped__
    for name, lib in libs.items():  # the wrappers' argument types, on the timed copies
        getattr(lib, names[name]).argtypes = getattr(real(name)[0], names[name]).argtypes
        getattr(lib, names[name]).restype = ctypes.c_int
    kgru._entry = lambda name: (libs[name], getattr(libs[name], names[name]))
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    rows = []

    def inputs(b, l, h):
        gx = (torch.randn(b, l, 3 * h, generator=g) * 0.5).to(dev)
        w = (torch.rand(3 * h, h, generator=g) * 2 - 1).div_(h ** 0.5).to(dev)
        return gx, w, torch.zeros(3 * h, device=dev), torch.ones(b, l, device=dev)

    for b, l, h, dt in ((128, 24, 1024, torch.bfloat16), (1, 24, 1024, torch.bfloat16),
                        (128, 24, 1024, torch.float32), (1, 24, 1024, torch.float32),
                        (128, 36, 2048, torch.bfloat16), (128, 24, 2048, torch.float32)):
        gx, w, bh, m = inputs(b, l, h)
        for _ in range(3):
            kgru._launch(gx, m, w.to(dt), bh, False, False)
        p = phases(libs["gru"])
        rows.append({"kernel": "gru", "b": b, "l": l, "h": h, "mode": str(dt)[6:],
                     "us_a_step": {"product": p[0] / (l - 1), "epilogue": (p[1] + p[3]) / l,
                                   "barrier": p[2] / (l - 1)}})
    for b, l, h in ((128, 48, 1024), (1, 48, 1024), (128, 24, 2048)):
        gx, w, bh, m = inputs(b, l, h)
        _, _, hall, ghall = gru_fwd_plain(gx, m, w, bh)
        g_out = torch.randn(b, l, h, generator=g).to(dev)
        for _ in range(3):
            kgru.gru_bwd_fused(gx, m, hall, ghall, g_out, None, w)
        p = phases(libs["gru_bwd"])
        rows.append({"kernel": "gru_bwd", "b": b, "l": l, "h": h, "mode": "float32",
                     "us_a_step": {"product": p[0] / l, "epilogue": (p[1] + p[3]) / l,
                                   "barrier": p[2] / l}})
    for r in rows:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
