"""Where CAMERA's AGSA backward spends its time, on the card.

    python -m itrx_torch.tools.agsa_phases

Builds csrc/agsa_attn_bwd.cu as the port builds it and with `-D` cuts that
stop its fp32 head pass early, runs each build through the wrapper at
CAMERA's two AGSA calls (B 128, 64 heads, N 36 image regions or 32 text
slots, d_k 32), fp32 and bf16, and times it with CUDA events (the median of
5 runs of 20 calls, with the spread), beside the forward (csrc/agsa_attn.cu,
the PR 11 design in both dtypes).  The cuts (fp32; bf16 keeps the PR 12
design, timed whole): ITRX_AGSA_BWD_CUT=1 stages the inputs and recomputes
the chain up to qm and km; =2 adds the attention adjoints (dv, g_qm, g_km);
=3 the gate adjoints, dq and dk; the full build adds the weight sums.
Printed as phases: recompute, attention adjoints, gate adjoints, weight
sums.

It also prints each full build's device milliseconds by launch from
`torch.profiler` (the kernels and the wrapper's own torch ops).  A cut
writes what it has computed so far into the outputs, so that the compiler
keeps it: its results are wrong by design.

Every build lives under build/itrx_torch_kernels/ beside the port's; the
library the port runs is not touched.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from ..ops.kernels import agsa_attn as ka

SHAPES = {"img": (128, 64, 36, 32), "txt": (128, 64, 32, 32)}
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("agsa_phases: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for tower, (b, h, n, dk) in SHAPES.items():
        (q, k, v), ws, go = inputs(b, h, n, dk)
        for dt in (torch.float32, torch.bfloat16):
            x = [t.to(dt) for t in (q, k, v)]
            w = [t.to(dt) for t in ws]
            g = go.to(dt)
            cuts = dt == torch.float32
            with torch.no_grad():
                fwd = _ms(lambda: ka._launch_fwd(*x, w, h))
                bwd = {name: _ms(lambda d=d: ka._launch_bwd(*x, w, g, h, defines=d))
                       for name, d in (BWD_CUTS if cuts else BWD_CUTS[-1:])}
                fwd_launch = by_launch(lambda: ka._launch_fwd(*x, w, h))
                bwd_launch = by_launch(lambda: ka._launch_bwd(*x, w, g, h))
            row = {"tower": tower, "shape": [b, h, n, dk], "mode": str(dt)[6:],
                   "fwd_ms": fwd, "fwd_by_launch_ms": fwd_launch, "bwd_ms": bwd,
                   "bwd_by_launch_ms": bwd_launch}
            if cuts:
                bm = {k_: v_["median"] for k_, v_ in bwd.items()}
                row["bwd_phase_ms"] = {
                    "recompute": bm["recompute"],
                    "attention_adjoints": round(bm["adjoints"] - bm["recompute"], 4),
                    "gate_adjoints": round(bm["gates"] - bm["adjoints"], 4),
                    "weight_sums": round(bm["full"] - bm["gates"], 4)}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
