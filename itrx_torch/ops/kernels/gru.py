"""Masked GRU recurrence on the card: wrapper of csrc/gru.cu.

Replaces the TPU kernel itrx/ops/pallas/gru.py::_fwd_kernel (entry
`gru_scan_fused`).  What bounds it on an H100: L sequential steps, each a
(B, H) x (H, 3H) product whose (3H, H) weight (12 MB fp32 / 6 MB bf16 at
H = 1024) cannot sit in one SM's shared memory as it sat in the TPU's VMEM.
The kernel therefore launches once per step, splits the hidden units over
blocks (each block computes the three gates of its own units, so the gate
math needs no exchange between blocks) and leaves the weight to the 50 MB
L2 between launches.  See the header of csrc/gru.cu.

The input projection x @ W_ih^T + b_ih is one large torch.matmul outside the
kernel, as the JAX package computes it outside its Pallas kernel.  The
plain version is `itrx_torch.ops.rnn.gru_scan`; it runs only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import check, current_stream, load, ptr

SOURCE = "gru.cu"


def _launch(gates_x, m, w_hh, b_hh, reverse: bool):
    """gates_x (B, L, 3H) fp32; m (B, L) fp32; w_hh (3H, H) fp32 or bf16;
    b_hh (3H) fp32, all contiguous on one CUDA device.  Returns
    (outs (B, L, H) fp32, final (B, H) fp32)."""
    B, L, H3 = gates_x.shape
    H = H3 // 3
    lib = load("gru")
    fn = lib.itrx_gru_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    outs = torch.empty(B, L, H, dtype=torch.float32, device=gates_x.device)
    hbuf = torch.empty(2, B, H, dtype=torch.float32, device=gates_x.device)
    code = fn(
        ptr(gates_x), ptr(m), ptr(w_hh), int(w_hh.dtype == torch.bfloat16),
        ptr(b_hh), ptr(hbuf), ptr(outs), B, L, H, int(reverse),
        gates_x.device.index, current_stream(gates_x.device),
    )
    check(lib, "gru_step_kernel", code)
    gru_scan_fused.launches += L
    return outs, hbuf[(L - 1) % 2]


def gru_scan_fused(x, mask, w_ih, w_hh, b_ih, b_hh, reverse: bool = False):
    """Masked GRU over x (B, L, D) with mask (B, L); weights in
    torch.nn.GRU layout.  Returns (outputs (B, L, H) in x's dtype, zero at
    pads; final (B, H)).  A CPU tensor takes the plain `gru_scan`; a CUDA
    tensor launches the kernel (fp32 or bf16 W_hh, fp32 carry); any other
    device raises."""
    if x.device.type == "cpu":
        from ..rnn import gru_scan

        return gru_scan(x, mask, w_ih, w_hh, b_ih, b_hh, reverse=reverse)
    if x.device.type != "cuda":
        raise ValueError(f"gru_scan_fused: no kernel for device {x.device}")
    B, L, D = x.shape
    H = w_hh.shape[1]
    if L < 1 or B < 1:
        raise ValueError(f"gru_scan_fused: empty input {tuple(x.shape)}")
    if tuple(w_ih.shape) != (3 * H, D) or tuple(w_hh.shape) != (3 * H, H):
        raise ValueError("gru_scan_fused: weights must be (3H, D) and (3H, H)")
    if tuple(mask.shape) != (B, L):
        raise ValueError(f"gru_scan_fused: mask {tuple(mask.shape)} != {(B, L)}")
    if w_hh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru_scan_fused: W_hh dtype {w_hh.dtype} unsupported")
    for t in (mask, w_ih, w_hh, b_ih, b_hh):
        if t.device != x.device:
            raise ValueError("gru_scan_fused: all tensors must be on one device")
    gates_x = (torch.matmul(x, w_ih.t()) + b_ih).float().contiguous()
    outs, final = _launch(
        gates_x, mask.float().contiguous(), w_hh.contiguous(),
        b_hh.float().contiguous(), reverse,
    )
    return outs.to(x.dtype), final.to(x.dtype)


# kernel launches (one per timestep) since the last reset
gru_scan_fused.launches = 0
