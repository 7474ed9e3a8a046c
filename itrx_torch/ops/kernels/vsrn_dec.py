"""VSRN's teacher-forced caption decoder on the card: the wrappers of
csrc/vsrn_dec.cu (forward) and csrc/vsrn_dec_bwd.cu (backward).

They replace the TPU kernels itrx/ops/pallas/vsrn_dec.py::_fwd_kernel and
::_bwd_kernel (the custom VJP `_dec_seq`).  From h_0, for each of the T steps
(the word half of the input projection, the encoder half of the attention
and the vocab projection are hoisted outside, as in `itrx`):

    hq  = h Watt^T
    o   = tanh(enc_att + hq),  alpha = softmax_R(o w2)
    ctx = (alpha enc_out) * cmask_t
    gx  = ctx Wctx^T + gxw_t,  gh = h Whh^T + bhh
    h  <- GRU cell (r, z, n in torch.nn.GRU's order)

Arguments, in the port's torch layouts: gxw (T, B, 3H) = words W_word^T +
b_ih; cmask (T, B, H), the context-dropout masks pre-scaled by 1 / keep
(ones without dropout); enc_out, enc_att (B, R, H); h0 (B, H); watt (H, H) =
attention.linear1.weight[:, H:] (out, in); w2 (1, H) = attention.linear2
.weight; wctx (3H, H) = rnn.weight_ih_l0[:, word_dim:]; whh (3H, H); bhh
(3H).  The states hs (T, B, H) come back; the residuals h_{t-1} (`hall`) and
gh (`ghall`) are saved for the backward, which recomputes the attention and
the gates from them and carries only the state's cotangent from step to
step.

Everything is fp32 (float64 on the plain pair for gradcheck).  `itrx` calls
its kernel only under bf16 training, with bf16 operands; the port has no
bf16 training yet (ROADMAP queue 1 item 7), so every CUDA training step goes
to the fp32 kernels.  A CPU tensor takes the plain pair; a CUDA tensor
launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import check, current_stream, load, ptr

SOURCE = "vsrn_dec.cu"
BWD_SOURCE = "vsrn_dec_bwd.cu"
MAX_REGIONS = 128
MAX_HIDDEN = 1024
# the backward's weight sums over the T x B rows: split into this many fixed
# parts, summed in order (no atomics, so two calls give identical gradients)
W_SPLITS = 8
_NAMES = ("gxw", "cmask", "enc_out", "enc_att", "h0", "watt", "w2", "wctx", "whh", "bhh")


def _work(t: torch.Tensor) -> torch.dtype:
    """The plain pair's arithmetic type: fp32, or float64 for float64 inputs
    (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _cell(gx, gh, h):
    """The GRU cell: (h', r, z, n)."""
    hd = h.shape[-1]
    r = torch.sigmoid(gx[:, :hd] + gh[:, :hd])
    z = torch.sigmoid(gx[:, hd:2 * hd] + gh[:, hd:2 * hd])
    n = torch.tanh(gx[:, 2 * hd:] + r * gh[:, 2 * hd:])
    return (1.0 - z) * n + z * h, r, z, n


def _attend(h, enca, enco, watt, w2v):
    """(o (B, R, H), alpha (B, R), the unmasked context (B, H))."""
    o = torch.tanh(enca + (h @ watt.t())[:, None, :])
    alpha = torch.softmax(o @ w2v, dim=1)
    return o, alpha, torch.einsum("br,brh->bh", alpha, enco)


def vsrn_dec_plain(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh):
    """The decode loop in plain PyTorch (the per-step loop of
    tests/test_pallas_vsrn_dec.py::_scan_ref), fp32 on the input values
    (float64 for float64 inputs), differentiable.  Returns (hs, hall,
    ghall): the states (T, B, H), h_{t-1} (T, B, H) and gh (T, B, 3H)."""
    wd = _work(gxw)
    gxw, cmask, enco, enca, h, watt, wctx, whh, bhh = (
        t.to(wd) for t in (gxw, cmask, enc_out, enc_att, h0, watt, wctx, whh, bhh))
    w2v = w2.reshape(-1).to(wd)
    hs, hall, ghall = [], [], []
    for t in range(gxw.shape[0]):
        _, _, ctx = _attend(h, enca, enco, watt, w2v)
        gx = (ctx * cmask[t]) @ wctx.t() + gxw[t]
        gh = h @ whh.t() + bhh
        hall.append(h)
        ghall.append(gh)
        h = _cell(gx, gh, h)[0]
        hs.append(h)
    return torch.stack(hs), torch.stack(hall), torch.stack(ghall)


@torch.no_grad()
def vsrn_dec_bwd_plain(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh, hall, ghall,
                       g_hs):
    """The backward in plain PyTorch, an explicit reverse loop with the
    algebra of itrx/ops/pallas/vsrn_dec.py::_bwd_kernel: the attention and
    the gates recomputed from the residuals hall and ghall, the state's
    cotangent carried from step to step.  Returns the cotangents of the ten
    inputs in their order and shapes (the mask's is zero), in the
    arithmetic's type."""
    wd = _work(gxw)
    gxw, cmask, enco, enca, watt, wctx, whh, hall, ghall, g_hs = (
        t.to(wd) for t in (gxw, cmask, enc_out, enc_att, watt, wctx, whh, hall, ghall, g_hs))
    w2v = w2.reshape(-1).to(wd)
    hd = hall.shape[-1]
    g = torch.zeros_like(hall[0])
    g_gxw = torch.zeros_like(gxw)
    g_enco, g_enca = torch.zeros_like(enco), torch.zeros_like(enca)
    d_watt, d_w2 = torch.zeros_like(watt), torch.zeros_like(w2v)
    d_wctx, d_whh = torch.zeros_like(wctx), torch.zeros_like(whh)
    d_bhh = torch.zeros(3 * hd, dtype=wd, device=gxw.device)
    for t in reversed(range(gxw.shape[0])):
        h, gh, cm = hall[t], ghall[t], cmask[t]
        o, alpha, ctx_raw = _attend(h, enca, enco, watt, w2v)
        ctx = ctx_raw * cm
        _, r, z, n = _cell(ctx @ wctx.t() + gxw[t], gh, h)
        # the GRU cell's adjoint
        g_ht = g + g_hs[t]
        g_n = g_ht * (1.0 - z)
        g_z = g_ht * (h - n)
        g_pren = g_n * (1.0 - n * n)
        g_prer = g_pren * gh[:, 2 * hd:] * r * (1.0 - r)
        g_prez = g_z * z * (1.0 - z)
        g_gx = torch.cat([g_prer, g_prez, g_pren], dim=1)
        g_gh = torch.cat([g_prer, g_prez, g_pren * r], dim=1)
        g_gxw[t] = g_gx
        g_prev = g_ht * z + g_gh @ whh
        d_whh += g_gh.t() @ h
        d_bhh += g_gh.sum(dim=0)
        # the context's and the attention's
        g_ctx = (g_gx @ wctx) * cm
        d_wctx += g_gx.t() @ ctx
        g_alpha = torch.einsum("bh,brh->br", g_ctx, enco)
        g_enco += alpha[:, :, None] * g_ctx[:, None, :]
        g_e = alpha * (g_alpha - (g_alpha * alpha).sum(dim=-1, keepdim=True))
        g_pre = g_e[:, :, None] * w2v * (1.0 - o * o)
        g_enca += g_pre
        d_w2 += torch.einsum("br,brh->h", g_e, o)
        g_hq = g_pre.sum(dim=1)
        g = g_prev + g_hq @ watt
        d_watt += g_hq.t() @ h
    return (g_gxw, torch.zeros_like(cmask), g_enco, g_enca, g, d_watt,
            d_w2.reshape(w2.shape), d_wctx, d_whh, d_bhh)


def _guard(name, args, hall=None, ghall=None, g_hs=None) -> str:
    """"cpu" or "cuda" for the wrapper `name`: any device other than the two
    raises; on a CUDA device every shape and type the kernels do not take
    raises."""
    gxw = args[0]
    if gxw.device.type == "cpu":
        return "cpu"
    if gxw.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {gxw.device}")
    t, b, h3 = gxw.shape
    hd = h3 // 3
    r = args[2].shape[1] if args[2].dim() == 3 else 0
    want = {"gxw": (t, b, 3 * hd), "cmask": (t, b, hd), "enc_out": (b, r, hd),
            "enc_att": (b, r, hd), "h0": (b, hd), "watt": (hd, hd), "w2": (1, hd),
            "wctx": (3 * hd, hd), "whh": (3 * hd, hd), "bhh": (3 * hd,)}
    shapes = {k: (a, want[k]) for k, a in zip(_NAMES, args)}
    for k, a, shape in (("hall", hall, (t, b, hd)), ("ghall", ghall, (t, b, 3 * hd)),
                        ("g_hs", g_hs, (t, b, hd))):
        if a is not None:
            shapes[k] = (a, shape)
    for k, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: {k} {tuple(a.shape)} != {shape}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be fp32, got {a.dtype}")
        if a.device != gxw.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    if t < 1 or b < 1 or h3 % 3 or not 1 <= hd <= MAX_HIDDEN:
        raise ValueError(f"{name}: T, B >= 1 and H in [1, {MAX_HIDDEN}], got "
                         f"{tuple(gxw.shape)}")
    if not 1 <= r <= MAX_REGIONS:
        raise ValueError(f"{name}: {r} regions not in [1, {MAX_REGIONS}]")
    return "cuda"


def _c(t):
    return t.detach().contiguous()


def _launch_fwd(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh, residuals: bool):
    """(hs, hall, ghall) from the forward kernels; hall and ghall are None
    unless `residuals`."""
    t, b, h3 = gxw.shape
    hd, r = h3 // 3, enc_out.shape[1]
    dev = gxw.device
    f32 = dict(dtype=torch.float32, device=dev)
    hs = torch.empty(t, b, hd, **f32)
    hall = torch.empty(t, b, hd, **f32) if residuals else None
    ghall = torch.empty(t, b, h3, **f32) if residuals else None
    ws_hq, ws_ctx, ws_gh = (torch.empty(b, hd, **f32), torch.empty(b, hd, **f32),
                            torch.empty(b, h3, **f32))
    lib = load("vsrn_dec")
    fn = lib.itrx_vsrn_dec_fwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launches have been queued
    ins = [_c(a) for a in (gxw, cmask, enc_out, enc_att, h0)]
    wcat_t = torch.cat([watt.detach(), whh.detach()], dim=0).t().contiguous()
    wctx_t = wctx.detach().t().contiguous()
    w2v, bhhc = _c(w2).reshape(-1), _c(bhh)
    opt = [ctypes.c_void_p(None) if a is None else ptr(a) for a in (hall, ghall)]
    code = fn(*(ptr(a) for a in ins), ptr(wcat_t), ptr(w2v), ptr(wctx_t), ptr(bhhc), ptr(hs),
              *opt, ptr(ws_hq), ptr(ws_gh), ptr(ws_ctx), t, b, r, hd, dev.index,
              current_stream(dev))
    check(lib, "vsrn_dec kernels", code)
    vsrn_dec_fused.launches += 1
    return hs, hall, ghall


def _launch_bwd(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh, hall, ghall, g_hs):
    t, b, h3 = gxw.shape
    hd, r = h3 // 3, enc_out.shape[1]
    dev = gxw.device
    f32 = dict(dtype=torch.float32, device=dev)
    g_gxw = torch.empty(t, b, h3, **f32)
    g_h0 = torch.empty(b, hd, **f32)
    g_enco, g_enca = torch.empty(b, r, hd, **f32), torch.empty(b, r, hd, **f32)
    d_watt, d_w2 = torch.empty(hd, hd, **f32), torch.empty(1, hd, **f32)
    d_wctx, d_whh, d_bhh = (torch.empty(h3, hd, **f32), torch.empty(h3, hd, **f32),
                            torch.empty(h3, **f32))
    rows = t * b
    ws = [torch.empty(rows, hd, **f32), torch.empty(rows, r, **f32),    # hq, alpha
          torch.empty(rows, hd, **f32), torch.empty(rows, h3, **f32),   # ctx, gx
          torch.empty(rows, h3, **f32), torch.empty(rows, hd, **f32),   # g_gh, g_hq
          torch.empty(rows, hd, **f32), torch.empty(b, hd, **f32),      # dw2 parts, gp
          torch.empty(b, hd, **f32), torch.empty(2, b, hd, **f32),      # g_ctx, carry
          torch.empty(W_SPLITS, 4 * hd, hd + 1, **f32),
          torch.empty(W_SPLITS, h3, hd, **f32)]
    lib = load("vsrn_dec_bwd")
    fn = lib.itrx_vsrn_dec_bwd
    fn.argtypes = [ctypes.c_void_p] * 33 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launches have been queued
    ins = [_c(a) for a in (gxw, cmask, enc_out, enc_att, hall, ghall, g_hs)]
    wcat = torch.cat([watt.detach(), whh.detach()], dim=0).contiguous()
    wcat_t = wcat.t().contiguous()
    w2v = _c(w2).reshape(-1)
    wctxc = _c(wctx)
    wctx_t = wctxc.t().contiguous()
    outs = (g_gxw, g_h0, g_enco, g_enca, d_watt, d_w2, d_wctx, d_whh, d_bhh)
    code = fn(*(ptr(a) for a in ins), ptr(wcat), ptr(wcat_t), ptr(w2v), ptr(wctxc),
              ptr(wctx_t), *(ptr(a) for a in outs), *(ptr(a) for a in ws), t, b, r, hd,
              W_SPLITS, dev.index, current_stream(dev))
    check(lib, "vsrn_dec_bwd kernels", code)
    vsrn_dec_bwd_fused.launches += 1
    return (g_gxw, torch.zeros_like(cmask), g_enco, g_enca, g_h0, d_watt, d_w2, d_wctx, d_whh,
            d_bhh)


def vsrn_dec_bwd_fused(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh, hall, ghall,
                       g_hs):
    """The backward: the cotangents of the ten inputs, in their order (the
    mask's is zero), from the forward's residuals and the states' cotangent
    g_hs.  A CPU tensor takes `vsrn_dec_bwd_plain`; a CUDA tensor launches
    the backward kernels (one count per call); any other device raises."""
    args = (gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh)
    if _guard("vsrn_dec_bwd_fused", args, hall, ghall, g_hs) == "cpu":
        return vsrn_dec_bwd_plain(*args, hall, ghall, g_hs)
    return _launch_bwd(*args, hall, ghall, g_hs)


class _VSRNDecode(torch.autograd.Function):
    """The decode loop under autograd (itrx's custom VJP `_dec_seq`).  It
    saves its inputs and the residuals hall (h_{t-1}, T x B x H) and ghall
    (T x B x 3H), as `itrx`'s forward saves them."""

    @staticmethod
    def forward(ctx, gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh):
        args = (gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh)
        if gxw.device.type == "cpu":
            hs, hall, ghall = vsrn_dec_plain(*args)
            hs = hs.to(gxw.dtype)
        else:
            hs, hall, ghall = _launch_fwd(*args, residuals=True)
        ctx.save_for_backward(*args, hall, ghall)
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        saved = ctx.saved_tensors
        grads = vsrn_dec_bwd_fused(*saved, g_hs.to(saved[-1].dtype).contiguous())
        return tuple(g.to(a.dtype) if need else None
                     for g, a, need in zip(grads, saved, ctx.needs_input_grad))


def vsrn_dec_fused(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh):
    """The teacher-forced decode: the states hs (T, B, H), differentiable in
    every input but the mask.  A CPU tensor takes `vsrn_dec_plain` (and
    `vsrn_dec_bwd_plain` in the backward); a CUDA tensor launches the forward
    kernels (and the backward kernels), fp32 only, or raises; any other
    device raises."""
    args = (gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh)
    dev = _guard("vsrn_dec_fused", args)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _VSRNDecode.apply(*args)
    with torch.no_grad():
        if dev == "cpu":
            return vsrn_dec_plain(*args)[0].to(gxw.dtype)
        return _launch_fwd(*args, residuals=False)[0]


# kernel launches since the last reset (each wrapper counts once per call)
vsrn_dec_fused.launches = 0
vsrn_dec_bwd_fused.launches = 0
