"""SCAN score grids on the card: wrappers of csrc/xattn.cu (t2i) and
csrc/xattn_i2t.cu (i2t).

Replace the TPU kernels itrx/ops/pallas/xattn.py::_kernel and ::_kernel_i2t
(wrappers `_xattn_t2i_fused_impl` / `_xattn_i2t_fused_impl`, entries
`xattn_t2i_fused` / `xattn_i2t_fused`): raw_feature_norm = clipped_l2norm
with LogSumExp or Mean, the published SCAN t-i and i-t variants.  What
bounds them on an H100: the raw dot product A = img . cap^T (36 x L x D
multiply-adds per pair) dominates, and the (Ni, Nc, 36, L) A tensor must
never reach device memory.  Both kernels form the A tiles of two images
against a group of whole captions in shared memory (on the tensor cores for
bf16 inputs, with fp32 FMAs for fp32 inputs) and run the whole chain there
in fp32 (see the headers of the sources).

As in the TPU wrappers, small things are precomputed here: for t2i the
per-image region Gram (fp32), the fp32 word norms and the masked captions;
for i2t the per-caption (L, L) word Gram of the masked captions (fp32), the
fp32 region norms and the masked captions.  The TPU layout workarounds
(block-diagonal Grams, 36 -> 40 region pad, 0/1 group matrices, padded
captions) are not carried over: the kernels mask their own ragged edges.
The plain versions are `xattn_t2i_plain` / `xattn_i2t_plain`; they run only
for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import attention
from . import check, current_stream, load, ptr

SOURCE = "xattn.cu"
I2T_SOURCE = "xattn_i2t.cu"
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


def _launch(direction: str, counted, images, capz, norm, mask, gram, lambda_lse,
            lambda_softmax, agg_mean: bool):
    """Launch `itrx_xattn_{direction}` of library `xattn` (t2i) or
    `xattn_i2t` (i2t) and add one to `counted.launches`.  `norm` is the fp32
    word norms (t2i) or region norms (i2t); `gram` the fp32 region Grams
    (t2i) or word Grams (i2t)."""
    ni, _, d = images.shape
    nc, l, _ = capz.shape
    lib = load("xattn" if direction == "t2i" else "xattn_i2t")
    fn = getattr(lib, f"itrx_xattn_{direction}")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(ni, nc, dtype=torch.float32, device=images.device)
    code = fn(
        ptr(images), ptr(capz), ptr(norm), ptr(mask), ptr(gram), ptr(out),
        ni, nc, l, d, int(images.dtype == torch.bfloat16),
        float(lambda_lse), float(lambda_softmax), int(agg_mean),
        images.device.index, current_stream(images.device),
    )
    check(lib, f"xattn_{direction}_kernel", code)
    counted.launches += 1
    return out


def _guard(name: str, images, captions, cap_mask, agg_func: str) -> str:
    """The guards both wrappers share.  Returns the device type, "cpu" or
    "cuda": the kernels are forward-only, as in the JAX package, so with grad
    enabled and an input that requires grad they raise on every device; any
    device other than the two raises; on a CUDA device every shape, type and
    alignment the kernel does not take raises."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (images, captions, cap_mask)
    ):
        raise RuntimeError(
            f"{name}: the kernel is forward-only (it has no backward); "
            "training similarity is the plain path, itrx_torch.ops.attention"
        )
    if agg_func not in ("LogSumExp", "Mean"):
        raise ValueError(f"{name}: unsupported agg_func {agg_func}")
    if images.device.type == "cpu":
        return "cpu"
    if images.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {images.device}")
    ni, r, d = images.shape
    nc, l, d2 = captions.shape
    if r != N_REGIONS:
        raise ValueError(f"{name}: the kernel takes {N_REGIONS} regions, got {r}")
    if d2 != d or tuple(cap_mask.shape) != (nc, l):
        raise ValueError(f"{name}: shapes of images, captions and mask disagree")
    if not 1 <= l <= MAX_WORDS:
        raise ValueError(f"{name}: caption length {l} not in [1, {MAX_WORDS}]")
    if images.dtype not in (torch.float32, torch.bfloat16) or captions.dtype != images.dtype:
        raise TypeError(f"{name}: images and captions must be both fp32 or both bf16")
    if captions.device != images.device or cap_mask.device != images.device:
        raise ValueError(f"{name}: all tensors must be on one device")
    if images.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"{name}: bf16 inputs need D % 8 == 0, got {d}")
    return "cuda"


def _masked(images, captions, cap_mask):
    """(contiguous images, captions zeroed at pads, fp32 mask), 16-byte
    aligned as the kernels read them."""
    mask = cap_mask.float().contiguous()
    capz = (captions * mask[..., None].to(captions.dtype)).contiguous()
    images = images.contiguous()
    if images.data_ptr() % 16 or capz.data_ptr() % 16:
        raise ValueError("xattn: inputs must be 16-byte aligned")
    return images, capz, mask


def xattn_t2i_fused(images, captions, cap_mask, *, lambda_lse: float = 6.0,
                    lambda_softmax: float = 9.0, agg_func: str = "LogSumExp"):
    """(Ni, 36, D) x (Nc, L, D) with cap_mask (Nc, L) -> (Ni, Nc) fp32.

    A CPU tensor takes `xattn_t2i_plain`; a CUDA tensor launches the kernel
    (fp32 or bf16 inputs, fp32 arithmetic); any other device raises.  The
    kernel is forward-only, as in the JAX package: with grad enabled and an
    input that requires grad it raises on every device."""
    if _guard("xattn_t2i_fused", images, captions, cap_mask, agg_func) == "cpu":
        return xattn_t2i_plain(
            images, captions, cap_mask, lambda_lse=lambda_lse,
            lambda_softmax=lambda_softmax, agg_func=agg_func,
        )
    images, capz, mask = _masked(images, captions, cap_mask)
    cap_norm = torch.sqrt(torch.sum(capz.float() ** 2, dim=-1)).contiguous()
    im32 = images.float()
    gram = torch.matmul(im32, im32.transpose(1, 2)).contiguous()  # (Ni, 36, 36)
    return _launch(
        "t2i", xattn_t2i_fused, images, capz, cap_norm, mask, gram, lambda_lse,
        lambda_softmax, agg_func == "Mean",
    )


def xattn_i2t_plain(images, captions, cap_mask, *, lambda_lse: float = 6.0,
                    lambda_softmax: float = 9.0, agg_func: str = "LogSumExp"):
    """The i2t function in plain PyTorch: xattn_score_i2t specialised to
    raw_feature_norm='clipped_l2norm'."""
    return attention.xattn_score_i2t(
        images, captions, cap_mask, raw_feature_norm="clipped_l2norm",
        agg_func=agg_func, lambda_lse=lambda_lse, lambda_softmax=lambda_softmax,
    )


def xattn_i2t_fused(images, captions, cap_mask, *, lambda_lse: float = 6.0,
                    lambda_softmax: float = 9.0, agg_func: str = "LogSumExp"):
    """i2t: (Ni, 36, D) x (Nc, L, D) with cap_mask (Nc, L) -> (Ni, Nc) fp32.

    A CPU tensor takes `xattn_i2t_plain`; a CUDA tensor launches the kernel
    (fp32 or bf16 inputs, fp32 arithmetic); any other device raises.  The
    kernel is forward-only, as in the JAX package: with grad enabled and an
    input that requires grad it raises on every device."""
    if _guard("xattn_i2t_fused", images, captions, cap_mask, agg_func) == "cpu":
        return xattn_i2t_plain(
            images, captions, cap_mask, lambda_lse=lambda_lse,
            lambda_softmax=lambda_softmax, agg_func=agg_func,
        )
    images, capz, mask = _masked(images, captions, cap_mask)
    im_norm = torch.sqrt(torch.sum(images.float() ** 2, dim=-1)).contiguous()  # (Ni, 36)
    cap32 = capz.float()
    gram = torch.matmul(cap32, cap32.transpose(1, 2)).contiguous()  # (Nc, L, L)
    return _launch(
        "i2t", xattn_i2t_fused, images, capz, im_norm, mask, gram, lambda_lse,
        lambda_softmax, agg_func == "Mean",
    )


# kernel launches since the last reset
xattn_t2i_fused.launches = 0
xattn_i2t_fused.launches = 0
