"""SGRAF's alignment chain in training, on the card: the wrappers of
csrc/sgraf_align.cu (forward) and csrc/sgraf_align_bwd.cu (backward).

They replace the TPU kernels itrx/ops/pallas/sgraf_align.py::_fwd_kernel and
::_bwd_kernel (the custom VJP `sgraf_align`).  For caption c (words l, mask
m) and image i (36 regions):

    a    = leaky_relu(img_i . cap_c^T, 0.1) * m          (36 x L)
    attn = a / ||a||_words                                (per region)
    s    = softmax_regions(9 attn)                        (per word)
    ctx  = l2norm_D(s img_i)
    out  = l2norm_S(W (ctx - cap)^2 + b) * m              (L x S)

with l2norm(x) = x / (sqrt(max(|x|^2, 1e-16)) + 1e-8), the port's `l2norm`.
The nodes of masked words are written as zeros and their cotangents are
ignored: downstream, SAF gives masked nodes zero weight and zero gradient,
and `itrx`'s kernel writes computed values there, which nothing reads.  The
plain pair does the same, so kernel, plain pair and `itrx` agree on valid
words.

The backward is the exact derivative of the plain forward: the l2norms'
backward keeps the term of the normalizer's derivative that `itrx`'s
kernel drops (its O(eps / |y|) correction, sgraf_align.py:136-138).

What bounds them on an H100: their products.  Per valid word and image the
forward does the A and context products (36 x D each) and the projection
(D x S); the backward recomputes them and adds W^T gy and the dW product
(D x S each) and four more 36 x D products (GS, dcap, both dimg terms).
Both run the projection and the context, and the backward every other
product, on the tensor cores as split-bf16 products (three bf16 passes,
a_hi b_lo + a_lo b_hi + a_hi b_hi, fp32 accumulation; two where one operand
is a bf16 embedding, which is exact; csrc/sgraf_nodes_mma.cuh), with the
weight split once a call (`split_weight`; the backward also
`split_weight_t`); only the A product stays as csrc/xattn_product.cuh forms
it (tensor cores for bf16 embeddings, fp32 FMAs for fp32).  Both keep the
chain in fp32 whatever the embeddings' dtype.  The forward writes every row
of its output, the zero rows of masked words too.  Neither reads anything
back to the host: the backward's rows are ranked on the card
(`row_layout`) and its workspaces sized from the shapes.

Arguments are the port's layouts: W (S, D) as torch stores it, b (S,).  A
CPU tensor takes the plain pair; a CUDA tensor launches the kernels or
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..norms import l2norm, safe_sqrt
from . import check, current_stream, load, ptr
from .sgraf_eval import SPLIT_DEPTH, split_weight

SOURCE = "sgraf_align.cu"
BWD_SOURCE = "sgraf_align_bwd.cu"
N_REGIONS = 36
MAX_WORDS = 128
MAX_SIM_DIM = 256
LAMBDA_SOFTMAX = 9.0
EPS = 1e-8
TINY = 1e-16
# captions per block of the kernels (csrc/xattn_product.cuh::caps_per_block)
BLOCK_WORDS = 128
MAX_CAPS = 32
# the backward's dW reduction over rows: split into this many fixed parts,
# summed in order (no atomics, so two calls give identical gradients)
GW_SPLITS = 16
# rows of D in one chunk of the backward's second weight orientation: the
# output columns of one ge product (two warpgroups of 128)
WT_CHUNK = 256


def _work(t: torch.Tensor) -> torch.dtype:
    """The plain pair's arithmetic type: fp32, or float64 for float64 inputs
    (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def split_weight_t(w: torch.Tensor) -> torch.Tensor:
    """W (S, D) in its second orientation, for the backward's ge = 2 e (gy W):
    W^T (D, S) padded with zero rows to whole chunks of WT_CHUNK rows of D,
    each chunk split as `split_weight` splits a weight (depth S), so that
    chunk j is contiguous: (D // WT_CHUNK, S32 // 32, 2, 2, WT_CHUNK // 8, 2,
    8, 8) bf16."""
    s, d = w.shape
    chunks = -(-d // WT_CHUNK)
    wt = F.pad(w.detach().float().t(), (0, 0, 0, chunks * WT_CHUNK - d))
    return split_weight(wt.reshape(chunks, WT_CHUNK, s))


def sgraf_align_plain(cap, mask, img, w, b):
    """The forward in plain PyTorch, fp32 on the input values (float64 for
    float64 inputs), differentiable.  cap (Nc, L, D), mask (Nc, L), img
    (Ni, 36, D), w (S, D), b (S,) -> (Nc, Ni, L, S) in cap's dtype, zero at
    masked words."""
    wd = _work(cap)
    c, m, im = cap.to(wd), mask.to(wd), img.to(wd)
    mm = m[:, None, :, None]
    a = F.leaky_relu(torch.einsum("cld,ird->cilr", c, im), 0.1) * mm  # (C, Ni, L, R)
    s = torch.softmax(l2norm(a, dim=2) * LAMBDA_SOFTMAX, dim=3)
    ctx = l2norm(torch.einsum("cilr,ird->cild", s, im))
    y = F.linear((ctx - c[:, None]) ** 2, w.to(wd), b.to(wd))
    return (l2norm(y) * mm).to(cap.dtype)


def _l2norm_bwd(x, g, dim: int):
    """The cotangent of x under l2norm(x) along `dim` for the output
    cotangent g: g inv - x (g . x) inv^2 / n with n = sqrt(max(|x|^2,
    1e-16)) and inv = 1 / (n + eps); the second term vanishes where the
    clamp holds (n does not move with x there)."""
    sq = (x * x).sum(dim, keepdim=True)
    n = safe_sqrt(sq)
    inv = 1.0 / (n + EPS)
    term = x * (g * x).sum(dim, keepdim=True) * inv * inv / n
    return g * inv - torch.where(sq > TINY, term, torch.zeros_like(term))


@torch.no_grad()
def sgraf_align_bwd_plain(cap, mask, img, w, b, g):
    """The backward in plain PyTorch: the exact derivative of
    `sgraf_align_plain` for the output cotangent g (Nc, Ni, L, S), the
    chain recomputed from the inputs.  Returns (gcap in cap's dtype, gimg in
    img's dtype, gw (S, D) and gb (S,) in fp32, float64 for float64
    inputs)."""
    wd = _work(cap)
    c, m, im, wf, bf = cap.to(wd), mask.to(wd), img.to(wd), w.to(wd), b.to(wd)
    mm = m[:, None, :, None]
    a = torch.einsum("cld,ird->cilr", c, im)
    h = F.leaky_relu(a, 0.1) * mm
    s = torch.softmax(l2norm(h, dim=2) * LAMBDA_SOFTMAX, dim=3)
    ctx = torch.einsum("cilr,ird->cild", s, im)
    e = l2norm(ctx) - c[:, None]
    diff = e * e
    y = F.linear(diff, wf, bf)
    gy = _l2norm_bwd(y, g.to(wd) * mm, -1)
    gw = torch.einsum("cils,cild->sd", gy, diff)
    gb = gy.sum(dim=(0, 1, 2))
    ge = 2.0 * e * (gy @ wf)
    gctx = _l2norm_bwd(ctx, ge, -1)
    gs = torch.einsum("cild,ird->cilr", gctx, im)
    gz = s * (gs - (gs * s).sum(-1, keepdim=True))
    gh = _l2norm_bwd(h, gz * LAMBDA_SOFTMAX, 2) * mm
    ga = torch.where(a > 0, gh, 0.1 * gh)
    gcap = torch.einsum("cilr,ird->cld", ga, im) - ge.sum(dim=1)
    gimg = torch.einsum("cilr,cild->ird", s, gctx) + torch.einsum("cilr,cld->ird", ga, c)
    return gcap.to(cap.dtype), gimg.to(img.dtype), gw, gb


def _guard(name, cap, mask, img, w, b, g=None) -> str:
    """"cpu" or "cuda" for the wrapper `name`: any device other than the two
    raises; on a CUDA device every shape, type and alignment the kernels do
    not take raises."""
    if img.device.type == "cpu":
        return "cpu"
    if img.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {img.device}")
    ni, r, d = img.shape
    nc, l, d2 = cap.shape
    s = w.shape[0]
    if r != N_REGIONS:
        raise ValueError(f"{name}: the kernel takes {N_REGIONS} regions, got {r}")
    if d2 != d or tuple(mask.shape) != (nc, l) or tuple(w.shape) != (s, d) \
            or tuple(b.shape) != (s,):
        raise ValueError(f"{name}: shapes of the inputs disagree")
    if g is not None and tuple(g.shape) != (nc, ni, l, s):
        raise ValueError(f"{name}: the cotangent must be (Nc, Ni, L, S) = "
                         f"{(nc, ni, l, s)}, got {tuple(g.shape)}")
    if not 1 <= l <= MAX_WORDS:
        raise ValueError(f"{name}: caption length {l} not in [1, {MAX_WORDS}]")
    if s > MAX_SIM_DIM or s % 4 or s < 4:
        raise ValueError(f"{name}: sim_dim {s} must be a multiple of 4 in [4, {MAX_SIM_DIM}]")
    if img.dtype not in (torch.float32, torch.bfloat16) or cap.dtype != img.dtype:
        raise TypeError(f"{name}: embeddings must be both fp32 or both bf16")
    if img.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"{name}: bf16 inputs need D % 8 == 0, got {d}")
    if any(t.device != img.device for t in (cap, mask, w, b) + ((g,) if g is not None else ())):
        raise ValueError(f"{name}: all tensors must be on one device")
    return "cuda"


def _f32(t):
    return t.detach().float().contiguous()


def _embeddings(name, cap, img):
    cap, img = cap.detach().contiguous(), img.detach().contiguous()
    if img.data_ptr() % 16 or cap.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return cap, img


def _launch_fwd(cap, mask, img, w, b):
    name = "sgraf_align_fused"
    ni, _, d = img.shape
    nc, l, _ = cap.shape
    s = w.shape[0]
    cap, img = _embeddings(name, cap, img)
    # the kernel writes every row, the zero rows of masked words too
    out = torch.empty(nc, ni, l, s, dtype=cap.dtype, device=img.device)
    im32 = img.float()
    gram = torch.matmul(im32, im32.transpose(1, 2)).contiguous()  # (Ni, 36, 36)
    lib = load("sgraf_align")
    fn = lib.itrx_sgraf_align
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launch has been queued
    maskf, wsplit, bf = _f32(mask), split_weight(w), _f32(b)
    code = fn(ptr(cap), ptr(maskf), ptr(img), ptr(gram), ptr(wsplit), ptr(bf), ptr(out),
              ni, nc, l, d, s, int(img.dtype == torch.bfloat16), img.device.index,
              current_stream(img.device))
    check(lib, "sgraf_align_kernel", code)
    sgraf_align_fused.launches += 1
    return out


def row_layout(mask):
    """The backward's compact rows: one per (caption, image, valid word),
    caption-major, then image, then word, formed on the device (nothing is
    read back).  Returns (pos (Nc, L) int32, the rank of each valid word in
    its caption; cstart (Nc + 1,) int32, the valid words before each
    caption, then the number of valid words)."""
    valid = (mask > 0).to(torch.int32)
    pos = (torch.cumsum(valid, dim=1) - valid).to(torch.int32).contiguous()
    ends = torch.cumsum(valid.sum(dim=1), dim=0)
    cstart = torch.cat([ends.new_zeros(1), ends]).to(torch.int32).contiguous()
    return pos, cstart


def _launch_bwd(cap, mask, img, w, b, g):
    name = "sgraf_align_bwd_fused"
    ni, _, d = img.shape
    nc, l, _ = cap.shape
    s = w.shape[0]
    dev = img.device
    cap, img = _embeddings(name, cap, img)
    g = g.detach().to(cap.dtype).contiguous()
    pos, cstart = row_layout(mask)
    # sized from the shapes: Nc L Ni rows at most (the count stays on the
    # card); D padded to the kernels' slab of 32
    rows = nc * l * ni
    dp = -(-d // SPLIT_DEPTH) * SPLIT_DEPTH
    gcap = torch.empty_like(cap)
    gimg = torch.empty_like(img)
    gw = torch.empty(s, d, dtype=torch.float32, device=dev)
    gb = torch.empty(s, dtype=torch.float32, device=dev)
    cpb = min(BLOCK_WORDS // l, MAX_CAPS)
    n_groups = -(-nc // cpb)
    f32 = dict(dtype=torch.float32, device=dev)
    # fp32 workspaces: e, then ge, then dcap per row; gy per row; the partial
    # sums of dimg (per caption group) and of dW and db (per split of the rows)
    ws = dict(e=torch.empty(rows, dp, **f32), gy=torch.empty(rows, s, **f32),
              gimg_p=torch.empty(n_groups, ni, N_REGIONS, dp, **f32),
              gw_p=torch.empty(GW_SPLITS, s, dp, **f32),
              gb_p=torch.empty(GW_SPLITS, s, **f32))
    im32 = img.float()
    gram = torch.matmul(im32, im32.transpose(1, 2)).contiguous()
    lib = load("sgraf_align_bwd")
    fn = lib.itrx_sgraf_align_bwd
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launches have been queued
    maskf, bf = _f32(mask), _f32(b)
    wsplit, wtsplit = split_weight(w), split_weight_t(w)
    code = fn(ptr(cap), ptr(maskf), ptr(img), ptr(gram), ptr(wsplit), ptr(wtsplit), ptr(bf),
              ptr(g), ptr(pos), ptr(cstart), ptr(gcap), ptr(gimg), ptr(gw), ptr(gb),
              *(ptr(ws[k]) for k in ("e", "gy", "gimg_p", "gw_p", "gb_p")),
              ni, nc, l, d, s, GW_SPLITS, int(img.dtype == torch.bfloat16), dev.index,
              current_stream(dev))
    check(lib, "sgraf_align_bwd_kernels", code)
    sgraf_align_bwd_fused.launches += 1
    return gcap, gimg, gw, gb


def sgraf_align_bwd_fused(cap, mask, img, w, b, g):
    """The backward: (gcap, gimg, gw, gb) for the output cotangent g.  A
    CPU tensor takes `sgraf_align_bwd_plain`; a CUDA tensor launches the
    backward kernels (one count per call); any other device raises."""
    if _guard("sgraf_align_bwd_fused", cap, mask, img, w, b, g) == "cpu":
        return sgraf_align_bwd_plain(cap, mask, img, w, b, g)
    return _launch_bwd(cap, mask, img, w, b, g)


class _SGRAFAlign(torch.autograd.Function):
    """The alignment chain under autograd.  It saves only its inputs (no
    chunk activation outlives the forward); the backward recomputes the
    chain, as `itrx`'s custom VJP does, which stands in for `sim_remat` on
    the chain."""

    @staticmethod
    def forward(ctx, cap, mask, img, w, b):
        ctx.save_for_backward(cap, mask, img, w, b)
        if img.device.type == "cpu":
            return sgraf_align_plain(cap, mask, img, w, b)
        return _launch_fwd(cap, mask, img, w, b)

    @staticmethod
    def backward(ctx, g):
        cap, mask, img, w, b = ctx.saved_tensors
        gcap, gimg, gw, gb = sgraf_align_bwd_fused(cap, mask, img, w, b, g)
        return gcap, None, gimg, gw.to(w.dtype), gb.to(b.dtype)


def sgraf_align_fused(cap, mask, img, w, b):
    """SGRAF's alignment nodes, (Nc, Ni, L, S) in the embeddings' dtype,
    zero at masked words; differentiable in cap, img, w and b.

    cap (Nc, L, D), mask (Nc, L), img (Ni, 36, D) fp32 or bf16; w (S, D),
    b (S,) -- sim_tranloc_w.  A CPU tensor takes `sgraf_align_plain` (and
    `sgraf_align_bwd_plain` in the backward); a CUDA tensor launches the
    forward kernel (and the backward kernels) or raises; any other device
    raises."""
    dev = _guard("sgraf_align_fused", cap, mask, img, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (cap, img, w, b)):
        return _SGRAFAlign.apply(cap, mask, img, w, b)
    with torch.no_grad():
        if dev == "cpu":
            return sgraf_align_plain(cap, mask, img, w, b)
        return _launch_fwd(cap, mask, img, w, b)


# kernel launches since the last reset (the backward counts once per call)
sgraf_align_fused.launches = 0
sgraf_align_bwd_fused.launches = 0
