"""Where the SGR reasoning forward spends its time, on the card.

    python -m itrx_torch.tools.sgr_fwd_phases

Builds a copy of csrc/sgr.cu with timers (the SM's %globaltimer, read by
thread 0 of every block) at the phase boundaries of its three passes, runs
it through the wrapper at one SGRAF-SGR training chunk (4096 pairs x 25
nodes, ragged 1-24 words, S 256, sgr_step 3), fp32 and bf16 step-0 nodes,
and prints the microseconds a block spends in each phase, on average over
the blocks that have work in it and summed over the three steps: the q
products (q = X M + v: q_kernel's for step 0, out_kernel's for the steps
after), out_kernel's masked rows' zeros and its product (relu(ctx Wg^T +
bg)), edge_kernel's staging (the X rows by cp.async, the row tables), units
and query rows; with the batches and rows an edge block takes.  Then, on
the port's own build, a forward call's host time (what the wrapper takes
to queue one call, over calls queued back to back) beside its CUDA-event
time, and the host time of the list's plain version (`row_list` +
`edge_bounds`, some thirty torch operations) that the plan kernels
replace.  The copy lives under build/sgr_fwd_phases/; the kernels the port
runs are not touched.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import time

import torch

from ..ops import kernels
from ..ops.kernels import sgr as ks
from .sgr_bwd_phases import build, card_name, inputs, read_timers

OUT = kernels.BUILD_DIR.parent / "sgr_fwd_phases"
# (slot, the phase) of the timers
PHASES = ((0, "q product"), (1, "out zero rows"), (2, "out product"), (3, "edge staging"),
          (4, "edge units"), (5, "edge query rows"))
# (marker in sgr.cu, the code put after it)
MARKS = (
    ("  if ((long long)blockIdx.x * kMmaRows >= n_rows) return;\n",
     "  unsigned long long since = phase_now();\n"),
    ("                                     row_at, mtsplit, S, Ks, S8);\n",
     "  phase_add(0, since);\n"),
    ("  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n",
     "  unsigned long long since = phase_now();\n"),
    ("    for (int c = 4 * lane; c < S; c += 128) *reinterpret_cast<float4*>(o + c) = z;\n  }\n",
     "  phase_add(1, since);\n"),
    ("                               gsplit, S, Ks, S8);\n", "  phase_add(2, since);\n"),
    ("                                 row_at, mtn, S, Ks, S8);\n", "    phase_add(0, since);\n"),
    ("  for (int q0 = p0; q0 < p1;) {\n", "    unsigned long long since = phase_now();\n"),
    ('    asm volatile("cp.async.wait_group 0;\\n" ::);\n    __syncthreads();\n',
     "    phase_add(3, since);\n"),
    ("    __syncthreads();\n    const int nu = n_units;\n", "    phase_add(4, since);\n"),
    ("    __syncthreads();  // the next batch restages the rows\n",
     "    phase_add(5, since);\n"
     "    if (threadIdx.x == 0) {\n"
     "      g_phase_ns[blockIdx.x][6] += 1;\n"
     "      g_phase_ns[blockIdx.x][7] += R;\n"
     "    }\n"),
)


def host_ms(fn, reps: int = 30) -> float:
    """Host milliseconds to queue one call of fn, calls back to back."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def event_ms(fn, reps: int = 30) -> float:
    """CUDA-event milliseconds a call of fn, calls back to back."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    print(f"card: {card_name()}", flush=True)
    lib = build("sgr.cu", MARKS, OUT)
    # the wrapper launches the timed copy of sgr.cu (the port's own build
    # of the rest)
    ks.load = lambda name: lib if name == "sgr" else kernels.load(name)
    dev = torch.device("cuda", 0)
    x, _ = inputs(dev)
    for dt in (torch.float32, torch.bfloat16):
        xd = dict(x, s0=x["s0"].to(dt))
        ks.sgr_reason_fwd_fused(**xd)
        blocks = read_timers(lib, lambda: ks.sgr_reason_fwd_fused(**xd))
        us, counts = {}, {}
        for slot, name in PHASES:
            busy = [b[slot] for b in blocks if b[slot]]
            counts[name] = len(busy)
            us[name] = round(sum(busy) / max(len(busy), 1) / 1e3, 2)
        edge = [b for b in blocks if b[6]]
        print(json.dumps({"kernels": "q_kernel, out_kernel, edge_kernel",
                          "shape": [4096, 25, 256, 3], "mode": str(dt).removeprefix("torch."),
                          "us_a_block": us, "blocks": counts,
                          "edge_batches_a_block": sum(b[6] for b in edge) / max(len(edge), 1),
                          "edge_rows_a_block": sum(b[7] for b in edge) / max(len(edge), 1)}),
              flush=True)
    ks.load = kernels.load
    blocks = ks.edge_blocks(x["mask"].shape[0], dev)
    with torch.no_grad():
        print(json.dumps({
            "forward_host_ms_a_call": round(host_ms(lambda: ks.sgr_reason_fused(**x)), 4),
            "forward_event_ms_a_call": round(event_ms(lambda: ks.sgr_reason_fused(**x)), 4),
            "row_list_and_edge_bounds_host_ms": round(host_ms(
                lambda: ks.edge_bounds(ks.row_list(x["mask"])[1], blocks)), 4),
            "card_plan_host_ms": round(host_ms(lambda: ks.card_plan(x["mask"], blocks)), 4)}),
            flush=True)


if __name__ == "__main__":
    main()
