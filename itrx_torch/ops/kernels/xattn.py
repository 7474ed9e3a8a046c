"""SCAN t2i score grid on the card: wrapper of csrc/xattn.cu.

Replaces the TPU kernel itrx/ops/pallas/xattn.py::_kernel (wrapper
`_xattn_t2i_fused_impl`, entry `xattn_t2i_fused`): raw_feature_norm =
clipped_l2norm with LogSumExp or Mean over words, the published SCAN t2i
variants.  What bounds it on an H100: the raw dot product A = img . cap^T
(36 x L x D multiply-adds per pair) dominates, and the (Ni, Nc, 36, L)
A tensor must never reach device memory.  The kernel forms the A tiles of
two images against a group of whole captions in shared memory (on the
tensor cores for bf16 inputs, with fp32 FMAs for fp32 inputs) and runs the
whole chain there in fp32 (see the header of csrc/xattn.cu).

As in the TPU wrapper, three small things are precomputed here: the
per-image region Gram (fp32), the fp32 word norms and the masked captions.
The TPU layout workarounds (block-diagonal Gram, 36 -> 40 region pad, 0/1
group matrices, padded captions) are not carried over: the kernel masks its
own ragged edges.  The plain version is `xattn_t2i_plain`; it runs only for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import attention
from . import check, current_stream, load, ptr

SOURCE = "xattn.cu"
N_REGIONS = 36
MAX_WORDS = 128


def xattn_t2i_plain(images, captions, cap_mask, *, lambda_lse: float = 6.0,
                    lambda_softmax: float = 9.0, agg_func: str = "LogSumExp"):
    """The same function in plain PyTorch: xattn_score_t2i specialised to
    raw_feature_norm='clipped_l2norm'."""
    return attention.xattn_score_t2i(
        images, captions, cap_mask, raw_feature_norm="clipped_l2norm",
        agg_func=agg_func, lambda_lse=lambda_lse, lambda_softmax=lambda_softmax,
    )


def _launch(images, capz, cap_norm, mask, gram, lambda_lse, lambda_softmax,
            agg_mean: bool):
    ni, _, d = images.shape
    nc, l, _ = capz.shape
    lib = load("xattn")
    fn = lib.itrx_xattn_t2i
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(ni, nc, dtype=torch.float32, device=images.device)
    code = fn(
        ptr(images), ptr(capz), ptr(cap_norm), ptr(mask), ptr(gram), ptr(out),
        ni, nc, l, d, int(images.dtype == torch.bfloat16),
        float(lambda_lse), float(lambda_softmax), int(agg_mean),
        images.device.index, current_stream(images.device),
    )
    check(lib, "xattn_t2i_kernel", code)
    xattn_t2i_fused.launches += 1
    return out


def xattn_t2i_fused(images, captions, cap_mask, *, lambda_lse: float = 6.0,
                    lambda_softmax: float = 9.0, agg_func: str = "LogSumExp"):
    """(Ni, 36, D) x (Nc, L, D) with cap_mask (Nc, L) -> (Ni, Nc) fp32.

    A CPU tensor takes `xattn_t2i_plain`; a CUDA tensor launches the kernel
    (fp32 or bf16 inputs, fp32 arithmetic); any other device raises.  The
    kernel is forward-only, as in the JAX package: with grad enabled and an
    input that requires grad it raises on every device."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (images, captions, cap_mask)
    ):
        raise RuntimeError(
            "xattn_t2i_fused: the kernel is forward-only (it has no backward); "
            "training similarity is the plain path, "
            "itrx_torch.ops.attention.xattn_score_t2i"
        )
    if agg_func not in ("LogSumExp", "Mean"):
        raise ValueError(f"xattn_t2i_fused: unsupported agg_func {agg_func}")
    if images.device.type == "cpu":
        return xattn_t2i_plain(
            images, captions, cap_mask, lambda_lse=lambda_lse,
            lambda_softmax=lambda_softmax, agg_func=agg_func,
        )
    if images.device.type != "cuda":
        raise ValueError(f"xattn_t2i_fused: no kernel for device {images.device}")
    ni, r, d = images.shape
    nc, l, d2 = captions.shape
    if r != N_REGIONS:
        raise ValueError(f"xattn_t2i_fused: the kernel takes {N_REGIONS} regions, got {r}")
    if d2 != d or tuple(cap_mask.shape) != (nc, l):
        raise ValueError("xattn_t2i_fused: shapes of images, captions and mask disagree")
    if not 1 <= l <= MAX_WORDS:
        raise ValueError(f"xattn_t2i_fused: caption length {l} not in [1, {MAX_WORDS}]")
    if images.dtype not in (torch.float32, torch.bfloat16) or captions.dtype != images.dtype:
        raise TypeError("xattn_t2i_fused: images and captions must be both fp32 or both bf16")
    if captions.device != images.device or cap_mask.device != images.device:
        raise ValueError("xattn_t2i_fused: all tensors must be on one device")
    if images.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"xattn_t2i_fused: bf16 inputs need D % 8 == 0, got {d}")
    mask = cap_mask.float().contiguous()
    capz = (captions * mask[..., None].to(captions.dtype)).contiguous()
    images = images.contiguous()
    if images.data_ptr() % 16 or capz.data_ptr() % 16:
        raise ValueError("xattn_t2i_fused: inputs must be 16-byte aligned")
    cap_norm = torch.sqrt(torch.sum(capz.float() ** 2, dim=-1)).contiguous()
    im32 = images.float()
    gram = torch.matmul(im32, im32.transpose(1, 2)).contiguous()  # (Ni, 36, 36)
    return _launch(
        images, capz, cap_norm, mask, gram, lambda_lse,
        lambda_softmax, agg_func == "Mean",
    )


# kernel launches since the last reset
xattn_t2i_fused.launches = 0
