"""Where CAMERA's AGSA kernels spend their time, on the card.

    python -m itrx_torch.tools.agsa_phases [--parent TREE]

Builds csrc/agsa_attn.cu (the forward) and csrc/agsa_attn_bwd.cu (the
backward) as the port builds them and with `-D` cuts that stop them early,
runs each build through the wrappers at CAMERA's two AGSA calls (B 128, 64
heads, N 36 image regions or 32 text slots, d_k 32), fp32 and bf16, and
times it with CUDA events (the median of 5 runs of 20 calls, with the
spread).  The forward's cuts (both dtypes): ITRX_AGSA_FWD_CUT=1 stages a
unit's q, k, v and writes v out; =2 adds the gates (qm, km); the full build
adds the attention.  Printed as phases: staging, gates, attention.  The
backward's (fp32; bf16 keeps its first design, timed whole):
ITRX_AGSA_BWD_CUT=1 stages the inputs and recomputes the chain up to qm and
km; =2 adds the attention adjoints (dv, g_qm, g_km); =3 the gate adjoints,
dq and dk; the full build adds the weight sums.  Printed as phases:
recompute, attention adjoints, gate adjoints, weight sums.

It also prints each full build's device milliseconds by launch from
`torch.profiler` (the kernels and the wrapper's own torch ops).  A cut
writes what it has computed so far into the outputs, so that the compiler
keeps it: its results are wrong by design.

`--parent TREE` (a checkout of another commit, e.g. unpacked with `git
archive`) also builds TREE's csrc/agsa_attn.cu, whose C entry takes the same
arguments, and prints for each forward call of chip_smoke.py's AGSA_SHAPES,
its B 129 grid and the plan's boundaries (CHECK_SHAPES), in both dtypes, how
many output elements differ between the two builds and between each build
and agsa_attention_plain; then times the two forwards at the towers' calls
in turns (parent, this tree, this tree, parent).

Every build lives under build/itrx_torch_kernels/ beside the port's; the
library the port runs is not touched.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import kernels
from ..ops.kernels import agsa_attn as ka

SHAPES = {"img": (128, 64, 36, 32), "txt": (128, 64, 32, 32)}
# chip_smoke.py's AGSA_SHAPES and AGSA_RAGGED_GRID, then the forward plan's
# boundaries (one key; keys past 32 in one or two extra tiles; d_k classes
# and a last head group short of G): (B, h, N, d_k)
CHECK_SHAPES = ((128, 64, 36, 32), (129, 64, 36, 32), (128, 64, 32, 32), (5, 3, 7, 8),
                (4, 2, 64, 128), (2, 3, 1, 64), (3, 2, 33, 32), (2, 5, 40, 24),
                (2, 7, 41, 40), (3, 6, 64, 16))
FWD_CUTS = (("staging", ("ITRX_AGSA_FWD_CUT=1",)), ("gates", ("ITRX_AGSA_FWD_CUT=2",)),
            ("full", ()))
BWD_CUTS = (("recompute", ("ITRX_AGSA_BWD_CUT=1",)), ("adjoints", ("ITRX_AGSA_BWD_CUT=2",)),
            ("gates", ("ITRX_AGSA_BWD_CUT=3",)), ("full", ()))


def _ms(fn, reps: int = 20, runs: int = 5) -> dict:
    """The median, least and most milliseconds a call over `runs` runs of
    `reps` calls (CUDA events), after a warm-up."""
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
    return {"median": round(statistics.median(times), 4), "min": round(min(times), 4),
            "max": round(max(times), 4)}


def by_launch(fn, calls: int = 5) -> dict:
    """Device milliseconds a call of `fn`, by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = e.cuda_time_total
        if dev and e.key and not e.key.startswith(("cuda", "aten::", "Activity")):
            out[e.key[:60]] = round(dev / 1e3 / calls, 4)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def inputs(b: int, h: int, n: int, dk: int, seed: int = 0):
    """q, k, v (B, N, h d_k), g_out, and the gate's weights at torch's init
    (U(-1/sqrt(d_k), 1/sqrt(d_k))) and biases, fp32 on the card, as
    chip_smoke.py::_agsa_inputs draws them."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.empty(*shape).uniform_(-dk ** -0.5, dk ** -0.5, generator=g)

    qkv = [torch.randn(b, n, h * dk, generator=g) for _ in range(3)]
    ws = [w for _ in range(4) for w in (u(dk, dk), u(dk))]
    g_out = torch.randn(b, n, h * dk, generator=g)
    dev = torch.device("cuda", 0)
    return [t.to(dev) for t in qkv], [w.to(dev) for w in ws], g_out.to(dev)


def parent_library(tree: str) -> ctypes.CDLL:
    """TREE's csrc/agsa_attn.cu built as the port builds its own (nvcc, the
    same flags), under a name of its own, and loaded."""
    src = Path(tree) / "itrx_torch" / "csrc" / ka.SOURCE
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = kernels.BUILD_DIR / f"agsa_attn-parent-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([kernels._nvcc(), *kernels._flags(()), "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.itrx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.itrx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Output elements that differ (NaN differs from everything)."""
    return int((a != b).sum())


def against_parent(parent: ctypes.CDLL) -> None:
    """Element counts between the parent's forward, this tree's and the
    plain version at CHECK_SHAPES, then both forwards' times in turns."""
    for i, (b, h, n, dk) in enumerate(CHECK_SHAPES):
        (q, k, v), ws, _ = inputs(b, h, n, dk, seed=100 + i)
        for dt in (torch.float32, torch.bfloat16):
            x = [t.to(dt) for t in (q, k, v)]
            w = [t.to(dt) for t in ws]
            with torch.no_grad():
                new = ka._launch_fwd(*x, w, h)
                again = ka._launch_fwd(*x, w, h)
                old = ka._launch_fwd(*x, w, h, lib=parent)
                plain = ka.agsa_attention_plain(*x, *w, h)
            torch.cuda.synchronize()
            row = {"shape": [b, h, n, dk], "mode": str(dt)[6:], "elements": new.numel(),
                   "this_vs_parent": _differ(new, old), "this_vs_plain": _differ(new, plain),
                   "parent_vs_plain": _differ(old, plain), "this_repeat": _differ(new, again)}
            print("BITS " + json.dumps(row), flush=True)
    for tower, (b, h, n, dk) in SHAPES.items():
        (q, k, v), ws, _ = inputs(b, h, n, dk)
        for dt in (torch.float32, torch.bfloat16):
            x = [t.to(dt) for t in (q, k, v)]
            w = [t.to(dt) for t in ws]
            with torch.no_grad():
                turns = []
                for who in ("parent", "this", "this", "parent"):
                    lib = parent if who == "parent" else None
                    turns.append((who, _ms(lambda lib=lib: ka._launch_fwd(*x, w, h, lib=lib))))
            print("TURNS " + json.dumps({"tower": tower, "mode": str(dt)[6:], "turns": turns}),
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="TREE", help="a checkout to compare the forward with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("agsa_phases: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    builds = [("agsa_attn", d) for _, d in FWD_CUTS] + [("agsa_attn_bwd", d) for _, d in BWD_CUTS]
    with ThreadPoolExecutor(len(builds) + 1) as ex:  # one nvcc a build, all at once
        done = [ex.submit(kernels.build, name, d) for name, d in builds]
        parent = ex.submit(parent_library, args.parent) if args.parent else None
        for f in done:
            f.result()
        parent = parent.result() if parent else None
    dev = torch.cuda.current_device()
    for tower, (b, h, n, dk) in SHAPES.items():
        (q, k, v), ws, go = inputs(b, h, n, dk)
        for dt in (torch.float32, torch.bfloat16):
            x = [t.to(dt) for t in (q, k, v)]
            w = [t.to(dt) for t in ws]
            g = go.to(dt)
            bf16 = dt == torch.bfloat16
            with torch.no_grad():
                fwd = {name: _ms(lambda d=d: ka._launch_fwd(*x, w, h,
                                                             lib=kernels.load("agsa_attn", d)))
                       for name, d in FWD_CUTS}
                fwd_launch = by_launch(lambda: ka._launch_fwd(*x, w, h))
            fm = {k_: v_["median"] for k_, v_ in fwd.items()}
            row = {"tower": tower, "shape": [b, h, n, dk], "mode": str(dt)[6:],
                   "fwd_plan": ka.fwd_plan(b, n, h, dk, bf16, dev), "fwd_ms": fwd,
                   "fwd_phase_ms": {"staging": fm["staging"],
                                    "gates": round(fm["gates"] - fm["staging"], 4),
                                    "attention": round(fm["full"] - fm["gates"], 4)},
                   "fwd_by_launch_ms": fwd_launch}
            with torch.no_grad():
                bwd = {name: _ms(lambda d=d: ka._launch_bwd(*x, w, g, h, defines=d))
                       for name, d in (BWD_CUTS[-1:] if bf16 else BWD_CUTS)}
                row["bwd_ms"] = bwd
                row["bwd_by_launch_ms"] = by_launch(lambda: ka._launch_bwd(*x, w, g, h))
            if not bf16:
                bm = {k_: v_["median"] for k_, v_ in bwd.items()}
                row["bwd_phase_ms"] = {
                    "recompute": bm["recompute"],
                    "attention_adjoints": round(bm["adjoints"] - bm["recompute"], 4),
                    "gate_adjoints": round(bm["gates"] - bm["adjoints"], 4),
                    "weight_sums": round(bm["full"] - bm["gates"], 4)}
            print(json.dumps(row), flush=True)
    if parent is not None:
        against_parent(parent)


if __name__ == "__main__":
    main()
