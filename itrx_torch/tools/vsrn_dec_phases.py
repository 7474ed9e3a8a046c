"""Where VSRN's caption-decoder kernels spend their time, on the card.

    python -m itrx_torch.tools.vsrn_dec_phases [--forward] [--launches]

At the training path's decode (T 59, B 128, R 36, H 512, context-dropout
keep 0.8; chip_smoke.py's inputs from seed 0), fp32, for the backward
(csrc/vsrn_dec_bwd.cu), or with --forward for the forward (csrc/vsrn_dec.cu):

1. the device milliseconds a call by launch kind (torch.profiler over 5
   calls after a warm-up);
2. (not with --launches) the microseconds a loop step spends in each phase,
   from a build with -DITRX_VSRN_DEC_PHASES (backward) or
   -DITRX_VSRN_DEC_FWD_PHASES (forward): block 0's thread 0 reads the SM's
   %globaltimer at every phase boundary, for each plan the loop can take on
   this card (two blocks sharing a unit slice, each taking half of the
   batch rows, or one).  The backward's phases are the cell, the g_ctx
   product, the attention adjoint, the carry product and three grid
   barriers; for its default plan two probe builds follow, whose products
   skip either the operand rows' loads from L2 or the tensor-core products
   (their gradients are wrong; they show which of the two paces a product).
   The forward's are the h product, the attention, the ctx product and the
   cell, and three grid barriers (two in the last step);
3. (not with --launches) the kernel the port runs, without timers, at each
   plan in turns (CUDA events).
The timed builds have library names of their own; the kernel the port runs
is not touched.

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..ops import kernels
from ..ops.kernels import vsrn_dec as kv

SHAPE = (59, 128, 36, 512, 0.8)
PHASE_DEFINE = ("ITRX_VSRN_DEC_PHASES",)
# measurement builds of the loop's products (their results are wrong): the
# operand rows never read from L2, or read and split without the mma
PROBES = {"": (), "no operand loads": ("ITRX_VSRN_DEC_PROBE_NO_LOADS",),
          "no products": ("ITRX_VSRN_DEC_PROBE_NO_PRODUCTS",)}
# the timers' slots, in csrc/vsrn_dec_bwd.cu's order
PHASES = ("cell", "barrier 1", "g_ctx product", "barrier 2", "attention adjoint", "barrier 3",
          "carry product")
FWD_PHASE_DEFINE = ("ITRX_VSRN_DEC_FWD_PHASES",)
# the forward's, in csrc/vsrn_dec.cu's order (no barrier after the last step)
FWD_PHASES = ("h product", "barrier 1", "attention", "barrier 2", "ctx product and cell",
              "barrier 3")


def inputs(dev):
    """chip_smoke.py's decode inputs at SHAPE (its seed-0 generator) and the
    plain forward's residuals."""
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    x, ghs = chip_smoke._vsrn_dec_inputs(g, *SHAPE)
    args = tuple(x.values())
    _, hall, ghall = kv.vsrn_dec_plain(*args)
    return args, hall, ghall, ghs


def launch_ms(fn, calls: int = 5) -> dict:
    """Device ms a call of each kernel `fn` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0)
        if us > 0:
            key = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = key.split("(")[0].split("<")[0].split("::")[-1].strip() or key[:40]
            out[name] = out.get(name, 0.0) + us / calls / 1e3
    return dict(sorted(out.items(), key=lambda kv_: -kv_[1]))


def run_plan(p, fn, which: str = "plan"):
    """fn() with the wrapper launching the loop plan p (`which`: the
    backward's "plan" or the forward's "fwd_plan")."""
    real = getattr(kv, which)
    setattr(kv, which, lambda *a, **k: p)
    try:
        return fn()
    finally:
        setattr(kv, which, real)


def timed_ms(fn, calls: int) -> float:
    """CUDA-event ms a call of fn over `calls` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def fwd_step_phases(args) -> list:
    """Block 0's microseconds a forward step by phase, for each plan."""
    lib = kernels.load("vsrn_dec", FWD_PHASE_DEFINE)
    real = kv.load
    kv.load = lambda name: lib if name == "vsrn_dec" else real(name)

    def fwd(p):
        return run_plan(p, lambda: kv._launch_fwd(*args, residuals=True, dot=None), "fwd_plan")

    rows = []
    try:
        t, b, r, h, _ = SHAPE
        for halves in kv.HALVES:
            p = kv.fwd_plan(b, r, h, sms=kv._sms(args[0].device), halves=halves)
            for _ in range(3):
                fwd(p)
            buf = (ctypes.c_ulonglong * len(FWD_PHASES))()
            torch.cuda.synchronize()
            kernels.check(lib, "itrx_vsrn_dec_fwd_phases",
                          lib.itrx_vsrn_dec_fwd_phases(ctypes.byref(buf)))
            us = {k: v / 1e3 / t for k, v in zip(FWD_PHASES, buf)}
            rows.append({"forward": True, "halves": p.halves, "blocks": p.blocks,
                         "route": p.route, "smem": p.smem,
                         "us_a_step": {k: round(v, 2) for k, v in us.items()},
                         "us_a_step_total": round(sum(us.values()), 2),
                         "timed_build_ms_a_call": round(timed_ms(lambda: fwd(p), 5), 3)})
    finally:
        kv.load = real
    return rows


def main_forward(args) -> None:
    """The forward's device ms by launch, its step by phase for each plan,
    then the kernel the port runs (no timers) at each plan in turns."""
    by_launch = launch_ms(lambda: kv._launch_fwd(*args, residuals=True, dot=None))
    print(json.dumps({"shape": SHAPE, "fwd_ms_by_launch": {k: round(v, 4)
                                                          for k, v in by_launch.items()},
                      "fwd_ms_sum": round(sum(by_launch.values()), 4)}), flush=True)
    if "--launches" in sys.argv[1:]:
        return
    for row in fwd_step_phases(args):
        print(json.dumps(row), flush=True)
    plans = [kv.fwd_plan(128, 36, 512, sms=kv._sms(args[0].device), halves=h)
             for h in kv.HALVES]
    ms = {f"halves {p.halves}": [] for p in plans}
    for p in plans + plans[::-1]:
        def fwd(p=p):
            return run_plan(p, lambda: kv._launch_fwd(*args, residuals=True, dot=None), "fwd_plan")
        for _ in range(2):
            fwd()
        ms[f"halves {p.halves}"].append(round(timed_ms(fwd, 10), 3))
    print(json.dumps({"fwd_ms_a_call_by_plan": ms}), flush=True)


def step_phases(args, hall, ghall, ghs, probe: str = "") -> list:
    """Block 0's microseconds a step by phase, for each plan (the default
    plan alone for a probe build)."""
    lib = kernels.load("vsrn_dec_bwd", PHASE_DEFINE + PROBES[probe])
    real = kv.load
    kv.load = lambda name: lib if name == "vsrn_dec_bwd" else real(name)
    def bwd(p):
        return run_plan(p, lambda: kv.vsrn_dec_bwd_fused(*args, hall, ghall, ghs))

    rows = []
    try:
        t, b, r, h, _ = SHAPE
        for halves in kv.HALVES[:1] if probe else kv.HALVES:
            try:
                p = kv.plan(b, r, h, sms=kv._sms(args[0].device), halves=halves)
            except ValueError as e:
                rows.append({"halves": halves, "refused": str(e)})
                continue
            for _ in range(3):
                bwd(p)
            buf = (ctypes.c_ulonglong * len(PHASES))()
            torch.cuda.synchronize()
            kernels.check(lib, "itrx_vsrn_dec_bwd_phases",
                          lib.itrx_vsrn_dec_bwd_phases(ctypes.byref(buf)))
            us = {k: v / 1e3 / t for k, v in zip(PHASES, buf)}
            rows.append({**({"probe": probe} if probe else {}),
                         "halves": p.halves, "blocks": p.blocks, "route": p.route,
                         "smem": p.smem,
                         "us_a_step": {k: round(v, 2) for k, v in us.items()},
                         "us_a_step_total": round(sum(us.values()), 2),
                         "timed_build_ms_a_call": round(timed_ms(lambda: bwd(p), 5), 3)})
    finally:
        kv.load = real
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("vsrn_dec_phases: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    args, hall, ghall, ghs = inputs(dev)
    if "--forward" in sys.argv[1:]:
        main_forward(args)
        return
    by_launch = launch_ms(lambda: kv.vsrn_dec_bwd_fused(*args, hall, ghall, ghs))
    print(json.dumps({"shape": SHAPE, "bwd_ms_by_launch": {k: round(v, 4)
                                                          for k, v in by_launch.items()},
                      "bwd_ms_sum": round(sum(by_launch.values()), 4)}), flush=True)
    if "--launches" in sys.argv[1:]:
        return
    for probe in PROBES:
        for row in step_phases(args, hall, ghall, ghs, probe):
            print(json.dumps(row), flush=True)
    # the kernel the port runs (no timers), each plan in turns, CUDA events
    plans = [kv.plan(128, 36, 512, sms=kv._sms(dev), halves=h) for h in kv.HALVES]
    ms = {f"halves {p.halves}": [] for p in plans}
    def bwd(p):
        return run_plan(p, lambda: kv.vsrn_dec_bwd_fused(*args, hall, ghall, ghs))

    for p in plans + plans[::-1]:
        for _ in range(2):
            bwd(p)
        ms[f"halves {p.halves}"].append(round(timed_ms(lambda: bwd(p), 10), 3))
    print(json.dumps({"bwd_ms_a_call_by_plan": ms}), flush=True)


if __name__ == "__main__":
    main()
