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

Two modes, chosen by enc_out's dtype.  fp32: every operand fp32 (float64
on the plain pair for gradcheck), for fp32 training.  bf16: `itrx` calls its
kernel only under bf16 training, with bf16 operands, at dot_dtype
"bfloat16"; so does the port under train_bf16: Watt, Wctx, Whh and enc_out
bf16, h, the context and the gradients rounded to bf16 before each product,
fp32 accumulation, the rest fp32.  A CPU tensor takes the plain pair in the
mode's arithmetic; a CUDA tensor launches the kernels or raises.

Both kernels run every product on the tensor cores as a split-bf16 product
(three passes) in the fp32 mode, one bf16 pass in the bf16 mode, on weights
laid out once a call here (the loops' fragments of the bf16 mode hold the
bf16 weights alone, half the bytes, so its plans keep them resident further).  The forward (csrc/vsrn_dec.cu) is the
decode loop as one persistent cooperative launch (`fwd_plan`, its fragments
`fwd_weights`).  The backward (csrc/vsrn_dec_bwd.cu) recomputes hq and gx
over every row (`split_rows`), runs the reverse loop as one persistent
cooperative launch (`plan`, `loop_weights`), then the attention's sums over
t and the weight sums.  A plan gives the blocks, how many share a slice of 8
hidden units, whether the loop's weight fragments stay resident in shared
memory or stream, and the shared-memory bytes; plans are pure Python, held
by the CPU tests.  Neither kernel reads anything back to the host.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import check, current_stream, load, ptr
from .sgraf_eval import SPLIT_DEPTH, SPLIT_ROWS, bf16_split, split_weight

SOURCE = "vsrn_dec.cu"
BWD_SOURCE = "vsrn_dec_bwd.cu"
MAX_REGIONS = 128
MAX_HIDDEN = 1024
# the backward's weight sums over the T x B rows: split into this many fixed
# parts, summed in order (no atomics, so two calls give identical gradients)
W_SPLITS = 8
_NAMES = ("gxw", "cmask", "enc_out", "enc_att", "h0", "watt", "w2", "wctx", "whh", "bhh")
# the operands that the bf16 mode takes in bf16 (the rest stay fp32)
_BF16_NAMES = ("enc_out", "watt", "wctx", "whh")
# the backward loop's constants (csrc/vsrn_dec_bwd.cu, csrc/gru_persistent.cuh)
UNITS = 8  # hidden units a block
HALVES = (2, 1)  # blocks that share a block's units, each taking a share of the rows
K_ALIGN = 64  # the loop's products pad their depth to this
STAGES = 4  # ring depth of the streamed first-product fragments
STEP_BYTES = 512  # one n8 tile's split B fragments of a k16 step (32 lanes x 16 B)
STEP_BYTES_BF16 = 256  # the bf16 mode's: the bf16 weights alone (32 lanes x 8 B)
# static shared memory of a loop block: a g_ctx row, alpha and g_e of a row,
# the products' part sums (4 m-tiles x 32 lanes x 2 tiles x 4)
LOOP_STATIC_SMEM = (MAX_HIDDEN + 2 * MAX_REGIONS + 4 * 32 * 2 * 4) * 4
# the forward loop's n8 tiles a unit group: the product over h ([Watt ;
# Whh]: hq and gh's r, z, n) and over ctx (Wctx)
FWD_TILES = (4, 3)
# static shared memory of a forward loop block: an hq row and w2, a row's
# scores, the products' part sums (4 m-tiles x 32 lanes x 4 tiles x 4)
FWD_STATIC_SMEM = (2 * MAX_HIDDEN + MAX_REGIONS + 4 * 32 * 4 * 4) * 4
MAX_SMEM = 232_448  # shared memory one block may take on an H100
H100_SMS = 132
# output columns of one chunk of a split weight (two warpgroups of n128)
SPLIT_CHUNK = 256


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class LoopPlan:
    """How the backward's reverse loop runs: `blocks` = `halves` x ceil(H /
    UNITS) blocks; the `halves` blocks of units i (blocks halves i .. halves
    i + halves - 1) own hidden units [i UNITS, (i + 1) UNITS) and each takes
    1 / `halves` of the batch rows; the block's fragments of the first
    product's weights (`loop_weights`' f1, two n8 tiles) "resident" in shared
    memory for all steps beside f3's or "streamed" through a ring each step;
    `smem` bytes of dynamic shared memory a block; the padded depths of the
    two products (H and 4H rounded up to K_ALIGN)."""

    halves: int
    blocks: int
    route: str
    smem: int
    k1: int
    k4: int


@dataclass(frozen=True)
class FwdPlan:
    """How the forward's decode loop runs: as LoopPlan, with the block's
    fragments of Wctx (`fwd_weights`' fc, three n8 tiles) "resident" in
    shared memory beside fh's (four tiles) or "streamed" through a ring each
    step; `k1` the products' padded depth (H rounded up to K_ALIGN)."""

    halves: int
    blocks: int
    route: str
    smem: int
    k1: int


def _loop_route(name: str, batch: int, regions: int, hidden: int, sms: int,
                halves: int | None, resident: int, streamed: int, static: int) -> tuple:
    """(halves, blocks, route, smem) of a loop at (B, R, H) on a card of
    `sms` SMs: the most blocks that share a unit slice (of HALVES, or
    `halves`) with one block an SM, the fragments resident where `resident`
    bytes fit beside the `static` shared memory, else `streamed` bytes with
    one block a slice.  Raises ValueError for a request the kernels do not
    take."""
    if batch < 1 or not 1 <= regions <= MAX_REGIONS or not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"vsrn_dec {name}: B >= 1, R in [1, {MAX_REGIONS}], H in "
                         f"[1, {MAX_HIDDEN}], got {(batch, regions, hidden)}")
    if halves is not None and halves not in HALVES:
        raise ValueError(f"vsrn_dec {name}: {halves} blocks a unit slice not in {HALVES}")
    groups = -(-hidden // UNITS)
    hv = next((x for x in ((halves,) if halves else HALVES) if x * groups <= sms), None)
    if hv is None:
        raise ValueError(f"vsrn_dec {name}: H {hidden} needs {groups} blocks of {UNITS} units "
                         f"{'x ' + str(halves) + ' ' if halves else ''}on {sms} SMs")
    if resident <= MAX_SMEM - static:
        return hv, hv * groups, "resident", resident
    if hv == 2:  # the streamed ring takes one part of the depth a block
        raise ValueError(f"vsrn_dec {name}: H {hidden} streams its weights; "
                         "two blocks a unit slice need them resident")
    return hv, hv * groups, "streamed", streamed


def plan(batch: int, regions: int, hidden: int, *, sms: int = H100_SMS,
         halves: int | None = None, bf16: bool = False) -> LoopPlan:
    """The backward loop's launch plan (`_loop_route`): f1's fragments
    resident where both products' fit shared memory.  The bf16 mode's
    fragments are half the bytes (the lo halves drop), so its weights stay
    resident up to H 1024 where the fp32 mode's stream past H 768."""
    k1, k4 = _round_up(hidden, K_ALIGN), _round_up(4 * hidden, K_ALIGN)
    sb = STEP_BYTES_BF16 if bf16 else STEP_BYTES
    w3 = k1 // 16 * sb
    hv, blocks, route, smem = _loop_route(
        "plan", batch, regions, hidden, sms, halves, w3 + k4 // 16 * 2 * sb,
        w3 + STAGES * 2 * (K_ALIGN // 16) * sb, LOOP_STATIC_SMEM)
    return LoopPlan(halves=hv, blocks=blocks, route=route, smem=smem, k1=k1, k4=k4)


def fwd_plan(batch: int, regions: int, hidden: int, *, sms: int = H100_SMS,
             halves: int | None = None, bf16: bool = False) -> FwdPlan:
    """The forward loop's launch plan (`_loop_route`): fc's fragments
    resident where both products' fit shared memory (H <= 960; the bf16
    mode's half-size fragments up to H 1024)."""
    k1 = _round_up(hidden, K_ALIGN)
    sb = STEP_BYTES_BF16 if bf16 else STEP_BYTES
    wh, wc = (k1 // 16 * n * sb for n in FWD_TILES)
    hv, blocks, route, smem = _loop_route(
        "fwd_plan", batch, regions, hidden, sms, halves, wh + wc,
        wh + STAGES * FWD_TILES[1] * (K_ALIGN // 16) * sb, FWD_STATIC_SMEM)
    return FwdPlan(halves=hv, blocks=blocks, route=route, smem=smem, k1=k1)


@functools.cache
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(dev: torch.device) -> int:
    return _sms_of(dev.index if dev.index is not None else torch.cuda.current_device())


def split_rows(w: torch.Tensor) -> tuple:
    """A weight w (N, K), (out, in) as torch stores it, in the backward's
    tensor-core form: cut into chunks of S8 = min(SPLIT_CHUNK, N rounded up
    to SPLIT_ROWS) output rows (zero rows past N), each chunk as
    `split_weight` lays a weight out, so chunk j is contiguous.  Returns
    (the split chunks (N8 // S8, K32 // 32, 2, 2, S8 // 8, 2, 8, 8) bf16,
    S8)."""
    n, k = w.shape
    s8 = min(SPLIT_CHUNK, _round_up(n, SPLIT_ROWS))
    chunks = -(-n // s8)
    wp = F.pad(w.detach().float(), (0, 0, 0, chunks * s8 - n))
    return split_weight(wp.reshape(chunks, s8, k)), s8


def _fragments(w: torch.Tensor, tiles: int, k: int, groups: int,
               bf16: bool = False) -> torch.Tensor:
    """Weight rows w (tiles H, K: tile q's output unit j is row q H + j) as
    the loop's split B fragments of mma.sync m16n8k16: per group of UNITS
    units, per k16 step, per n8 tile, per lane (g = lane // 4 the unit, t =
    lane % 4), the bf16 hi of columns 4t .. 4t + 3 of the step then their lo
    (`bf16_split`), so that a lane's 16 bytes are its fragment registers b0,
    b1 (hi) and b0, b1 (lo) with fragment slots 2t, 2t + 1, 2t + 8, 2t + 9
    holding those columns, as the kernel reads its A rows.  Zero past H (up
    to `groups` groups) and past the K columns up to k.  Returns (groups, k //
    16, tiles, 8, 4, 2, 4) bf16; with `bf16` (the bf16 mode) the weights'
    bf16 values alone, (groups, k // 16, tiles, 8, 4, 1, 4): 8 bytes a lane,
    b0 and b1."""
    rows, cols = w.shape
    hd = rows // tiles
    wp = F.pad(w.detach().float().reshape(tiles, hd, cols),
               (0, k - cols, 0, groups * UNITS - hd))
    # [tile][group][g][step][t][c] -> [group][step][tile][g][t][c]
    wp = wp.reshape(tiles, groups, UNITS, k // 16, 4, 4).permute(1, 3, 0, 2, 4, 5)
    if bf16:
        return wp.to(torch.bfloat16).unsqueeze(-2).contiguous()
    return torch.stack(bf16_split(wp), dim=-2).contiguous()


def loop_weights(watt, wctx, whh, k1: int, k4: int, groups: int, bf16: bool = False) -> tuple:
    """The reverse loop's weights as `_fragments`, rows j the output unit j
    of a product over an exchange row: f1 from w1 (2H, k4), whose rows j are
    Wctx^T over the exchange's columns [g_prer | g_prez | g_pren] (zero over
    its last H, g_pren r) and rows H + j Whh^T over [g_prer | g_prez | . |
    g_pren r] (zero over g_pren), so that one read of the exchange gives
    g_gx Wctx (tile 0) and g_gh Whh (tile 1); f3 from Watt^T (H, H), for
    g_hq Watt; `groups` groups of UNITS units each (ceil(H / UNITS)); with
    `bf16` the bf16 mode's fragments.  Returns (f1, f3)."""
    hd = watt.shape[0]
    f = lambda w: w.detach().float()  # noqa: E731
    whh_t = f(whh).t()
    w1 = torch.zeros(2 * hd, 4 * hd, dtype=torch.float32, device=watt.device)
    w1[:hd, :3 * hd] = f(wctx).t()
    w1[hd:, :2 * hd] = whh_t[:, :2 * hd]
    w1[hd:, 3 * hd:] = whh_t[:, 2 * hd:]
    return (_fragments(w1, 2, k4, groups, bf16),
            _fragments(f(watt).t(), 1, k1, groups, bf16))


def fwd_weights(watt, wctx, whh, k1: int, groups: int, bf16: bool = False) -> tuple:
    """The forward loop's weights as `_fragments`, rows j the output unit j
    of a product over an exchange row: fh from [Watt ; Whh] (4H, H), so that
    one read of the state exchange gives hq (tile 0) and gh's r, z, n (tiles
    1-3); fc from Wctx (3H, H) for gx; depth k1, `groups` groups of UNITS
    units; with `bf16` the bf16 mode's fragments.  Returns (fh, fc)."""
    f = lambda w: w.detach().float()  # noqa: E731
    return (_fragments(torch.cat([f(watt), f(whh)]), FWD_TILES[0], k1, groups, bf16),
            _fragments(f(wctx), FWD_TILES[1], k1, groups, bf16))


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


def _rounder(wd: torch.dtype, dot_dtype: torch.dtype | None):
    """x -> x rounded to `dot_dtype` and read back in `wd` (None: x)."""
    if dot_dtype is None:
        return lambda t: t
    return lambda t: t.to(dot_dtype).to(wd)


def _attend(h, enca, enco, watt, w2v):
    """(o (B, R, H), alpha (B, R), the unmasked context (B, H)); h is the
    product's operand (rounded by the caller)."""
    o = torch.tanh(enca + (h @ watt.t())[:, None, :])
    alpha = torch.softmax(o @ w2v, dim=1)
    return o, alpha, torch.einsum("br,brh->bh", alpha, enco)


def vsrn_dec_plain(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh,
                   dot_dtype: torch.dtype | None = None):
    """The decode loop in plain PyTorch (the per-step loop of
    tests/test_pallas_vsrn_dec.py::_scan_ref), fp32 on the input values
    (float64 for float64 inputs), differentiable.  Returns (hs, hall,
    ghall): the states (T, B, H), h_{t-1} (T, B, H) and gh (T, B, 3H).

    `dot_dtype` None: no rounding.  `torch.bfloat16`: the TPU kernel's
    arithmetic at dot_dtype="bfloat16" (itrx/ops/pallas/vsrn_dec.py::
    _fwd_kernel) and the CUDA forward's bf16 mode: Watt, Wctx and Whh are
    rounded to bf16, and so are h and the masked context before each of
    their products, which accumulate in fp32; enc_out is read as fp32 and
    the attention, the cell and the carry stay fp32; ghall comes back in
    bf16, as `itrx` saves it (the cell takes gh unrounded)."""
    wd = _work(gxw)
    rnd = _rounder(wd, dot_dtype)
    gxw, cmask, enco, enca, h, bhh = (
        t.to(wd) for t in (gxw, cmask, enc_out, enc_att, h0, bhh))
    watt, wctx, whh = (rnd(t.to(wd)) for t in (watt, wctx, whh))
    w2v = w2.reshape(-1).to(wd)
    hs, hall, ghall = [], [], []
    for t in range(gxw.shape[0]):
        _, _, ctx = _attend(rnd(h), enca, enco, watt, w2v)
        gx = rnd(ctx * cmask[t]) @ wctx.t() + gxw[t]
        gh = rnd(h) @ whh.t() + bhh
        hall.append(h)
        ghall.append(gh)
        h = _cell(gx, gh, h)[0]
        hs.append(h)
    ghall = torch.stack(ghall)
    return torch.stack(hs), torch.stack(hall), ghall if dot_dtype is None else ghall.to(dot_dtype)


@torch.no_grad()
def vsrn_dec_bwd_plain(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh, hall, ghall,
                       g_hs, dot_dtype: torch.dtype | None = None):
    """The backward in plain PyTorch, an explicit reverse loop with the
    algebra of itrx/ops/pallas/vsrn_dec.py::_bwd_kernel: the attention and
    the gates recomputed from the residuals hall and ghall, the state's
    cotangent carried from step to step.  Returns the cotangents of the ten
    inputs in their order and shapes (the mask's is zero), in the
    arithmetic's type.

    `torch.bfloat16` rounds as the TPU kernel does at dot_dtype="bfloat16"
    (and the CUDA backward's bf16 mode): the weights, and h, the masked
    context, g_gx, g_gh and g_hq before each product and weight sum (fp32
    accumulation); ghall enters as bf16 values (it may come in bf16, as the
    forward saves it); g_gxw leaves as bf16 values; dbhh sums the unrounded
    g_gh."""
    wd = _work(gxw)
    rnd = _rounder(wd, dot_dtype)
    gxw, cmask, enco, enca, hall, g_hs = (
        t.to(wd) for t in (gxw, cmask, enc_out, enc_att, hall, g_hs))
    watt, wctx, whh, ghall = (rnd(t.to(wd)) for t in (watt, wctx, whh, ghall))
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
        h_d = rnd(h)
        o, alpha, ctx_raw = _attend(h_d, enca, enco, watt, w2v)
        ctx_d = rnd(ctx_raw * cm)
        _, r, z, n = _cell(ctx_d @ wctx.t() + gxw[t], gh, h)
        # the GRU cell's adjoint
        g_ht = g + g_hs[t]
        g_n = g_ht * (1.0 - z)
        g_z = g_ht * (h - n)
        g_pren = g_n * (1.0 - n * n)
        g_prer = g_pren * gh[:, 2 * hd:] * r * (1.0 - r)
        g_prez = g_z * z * (1.0 - z)
        g_gx = torch.cat([g_prer, g_prez, g_pren], dim=1)
        g_gh = torch.cat([g_prer, g_prez, g_pren * r], dim=1)
        g_gx_d, g_gh_d = rnd(g_gx), rnd(g_gh)
        g_gxw[t] = g_gx_d
        g_prev = g_ht * z + g_gh_d @ whh
        d_whh += g_gh_d.t() @ h_d
        d_bhh += g_gh.sum(dim=0)
        # the context's and the attention's
        g_ctx = (g_gx_d @ wctx) * cm
        d_wctx += g_gx_d.t() @ ctx_d
        g_alpha = torch.einsum("bh,brh->br", g_ctx, enco)
        g_enco += alpha[:, :, None] * g_ctx[:, None, :]
        g_e = alpha * (g_alpha - (g_alpha * alpha).sum(dim=-1, keepdim=True))
        g_pre = g_e[:, :, None] * w2v * (1.0 - o * o)
        g_enca += g_pre
        d_w2 += torch.einsum("br,brh->h", g_e, o)
        g_hq = rnd(g_pre.sum(dim=1))
        g = g_prev + g_hq @ watt
        d_watt += g_hq.t() @ h_d
    return (g_gxw, torch.zeros_like(cmask), g_enco, g_enca, g, d_watt,
            d_w2.reshape(w2.shape), d_wctx, d_whh, d_bhh)


def _guard(name, args, dot, hall=None, ghall=None, g_hs=None) -> str:
    """"cpu" or "cuda" for the wrapper `name` in the mode `dot` (None: fp32,
    bf16: the bf16 mode): any device other than the two raises; on a CUDA
    device every shape and type the kernels do not take in that mode
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
    bf16 = dot is not None
    for k, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: {k} {tuple(a.shape)} != {shape}")
        want_dt = torch.bfloat16 if bf16 and k in _BF16_NAMES + ("ghall",) else torch.float32
        if a.dtype != want_dt:
            raise TypeError(f"{name}: {k} must be {want_dt} (the "
                            f"{'bf16' if bf16 else 'fp32'} mode, from enc_out), got {a.dtype}")
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


def _launch_fwd(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh, residuals: bool,
                dot):
    """(hs, hall, ghall) from the forward kernel in the mode `dot`; hall and
    ghall are None unless `residuals`."""
    t, b, h3 = gxw.shape
    hd, r = h3 // 3, enc_out.shape[1]
    dev = gxw.device
    bf16 = dot is not None
    p = fwd_plan(b, r, hd, sms=_sms(dev), bf16=bf16)
    f32 = dict(dtype=torch.float32, device=dev)
    hs = torch.empty(t, b, hd, **f32)
    hall = torch.empty(t, b, hd, **f32) if residuals else None
    # the bf16 mode saves ghall in bf16, its gh passing through ws_gh in fp32
    ghall = (torch.empty(t, b, h3, dtype=torch.bfloat16 if bf16 else torch.float32, device=dev)
             if residuals else None)
    ws = [torch.empty(b, p.k1, **f32), torch.empty(b, hd, **f32),  # state, hq
          torch.empty(b, p.k1, **f32)]                              # context
    ws_gh = None if residuals and not bf16 else torch.empty(b, h3, **f32)
    bar = torch.empty(2, dtype=torch.int32, device=dev)
    lib = load("vsrn_dec")
    fn = lib.itrx_vsrn_dec_fwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launch has been queued;
    # the bf16 mode reads enc_out as fp32 values
    ins = [_c(a.float()) for a in (gxw, cmask, enc_out, enc_att, h0)]
    w2v, bhhc = _c(w2).reshape(-1), _c(bhh)
    fh, fc = fwd_weights(watt, wctx, whh, p.k1, p.blocks // p.halves, bf16)
    opt = [ctypes.c_void_p(None) if a is None else ptr(a) for a in (hall, ghall)]
    code = fn(*(ptr(a) for a in ins), ptr(w2v), ptr(bhhc), ptr(fh), ptr(fc), ptr(hs), *opt,
              *(ptr(a) for a in ws), ctypes.c_void_p(None) if ws_gh is None else ptr(ws_gh),
              ptr(bar), t, b, r, hd, p.halves, p.blocks, int(p.route == "streamed"), p.smem,
              int(bf16), dev.index, current_stream(dev))
    check(lib, "vsrn_dec kernel", code)
    vsrn_dec_fused.launches += 1
    vsrn_dec_fused.bf16_launches += bf16
    return hs, hall, ghall


def _launch_bwd(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh, hall, ghall, g_hs,
                dot):
    t, b, h3 = gxw.shape
    hd, r = h3 // 3, enc_out.shape[1]
    dev = gxw.device
    bf16 = dot is not None
    p = plan(b, r, hd, sms=_sms(dev), bf16=bf16)
    f32 = dict(dtype=torch.float32, device=dev)
    g_gxw = torch.empty(t, b, h3, **f32)
    g_h0 = torch.empty(b, hd, **f32)
    g_enco, g_enca = torch.empty(b, r, hd, **f32), torch.empty(b, r, hd, **f32)
    d_watt, d_w2 = torch.empty(hd, hd, **f32), torch.empty(1, hd, **f32)
    d_wctx, d_whh, d_bhh = (torch.empty(h3, hd, **f32), torch.empty(h3, hd, **f32),
                            torch.empty(h3, **f32))
    rows = t * b
    rgroups = -(-r // 4)
    ws = [torch.empty(rows, hd, **f32), torch.empty(rows, hd, **f32),   # hq, ctx
          torch.empty(rows, hd, **f32), torch.empty(rows, r, **f32),    # g_ctx, alpha
          torch.empty(rows, r, **f32), torch.empty(rows, h3, **f32),    # g_e, gx
          torch.empty(rows, p.k4, **f32), torch.empty(b, p.k4, **f32),  # [g_hq | g_gh], exchange
          torch.empty(b, hd, **f32), torch.empty(b * rgroups, hd, **f32),  # gp, dw2 parts
          torch.empty(W_SPLITS, 4 * hd, hd, **f32), torch.empty(W_SPLITS, 4 * hd, **f32),
          torch.empty(W_SPLITS, h3, hd, **f32), torch.empty(2, dtype=torch.int32, device=dev)]
    lib = load("vsrn_dec_bwd")
    fn = lib.itrx_vsrn_dec_bwd
    fn.argtypes = [ctypes.c_void_p] * 35 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launches have been queued;
    # the bf16 mode reads enc_out as fp32 values and ghall in bf16 (its type)
    ins = [_c(a.float()) for a in (gxw, cmask, enc_out, enc_att, hall)] + [_c(ghall), _c(g_hs)]
    w2v = _c(w2).reshape(-1)
    watt_s, s8a = split_rows(watt)
    wctx_s, s8c = split_rows(wctx)
    f1, f3 = loop_weights(watt, wctx, whh, p.k1, p.k4, p.blocks // p.halves, bf16)
    outs = (g_gxw, g_h0, g_enco, g_enca, d_watt, d_w2, d_wctx, d_whh, d_bhh)
    code = fn(*(ptr(a) for a in ins), ptr(w2v), ptr(watt_s), ptr(wctx_s), ptr(f1), ptr(f3),
              *(ptr(a) for a in outs), *(ptr(a) for a in ws), t, b, r, hd, s8a, s8c,
              _round_up(hd, SPLIT_DEPTH), W_SPLITS, p.halves, p.blocks,
              int(p.route == "streamed"), p.smem, int(bf16), dev.index, current_stream(dev))
    check(lib, "vsrn_dec_bwd kernels", code)
    vsrn_dec_bwd_fused.launches += 1
    vsrn_dec_bwd_fused.bf16_launches += bf16
    return (g_gxw, torch.zeros_like(cmask), g_enco, g_enca, g_h0, d_watt, d_w2, d_wctx, d_whh,
            d_bhh)


def vsrn_dec_bwd_fused(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh, hall, ghall,
                       g_hs):
    """The backward: the cotangents of the ten inputs, in their order (the
    mask's is zero), from the forward's residuals and the states' cotangent
    g_hs.  A CPU tensor takes `vsrn_dec_bwd_plain`; a CUDA tensor launches
    the backward kernels (one count per call); any other device raises.
    The mode follows enc_out's dtype, as in `vsrn_dec_fused`."""
    args = (gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh)
    return _bwd(_dot_dtype(enc_out), args, hall, ghall, g_hs)


def _bwd(dot, args, hall, ghall, g_hs):
    """The backward in the mode `dot` on either device."""
    if _guard("vsrn_dec_bwd_fused", args, dot, hall, ghall, g_hs) == "cpu":
        return vsrn_dec_bwd_plain(*args, hall, ghall, g_hs, dot_dtype=dot)
    return _launch_bwd(*args, hall, ghall, g_hs, dot)


class _VSRNDecode(torch.autograd.Function):
    """The decode loop under autograd (itrx's custom VJP `_dec_seq`).  It
    saves its inputs and the residuals hall (h_{t-1}, T x B x H) and ghall
    (T x B x 3H), as `itrx`'s forward saves them."""

    @staticmethod
    def forward(ctx, dot, gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh):
        args = (gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh)
        if gxw.device.type == "cpu":
            hs, hall, ghall = vsrn_dec_plain(*args, dot_dtype=dot)
            hs = hs.to(gxw.dtype)
        else:
            hs, hall, ghall = _launch_fwd(*args, residuals=True, dot=dot)
        ctx.dot = dot
        ctx.save_for_backward(*args, hall, ghall)
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        saved = ctx.saved_tensors
        # g_hs in hall's type (ghall is bf16 in the bf16 mode)
        grads = _bwd(ctx.dot, saved[:-2], saved[-2], saved[-1],
                     g_hs.to(saved[-2].dtype).contiguous())
        return (None,) + tuple(g.to(a.dtype) if need else None
                               for g, a, need in zip(grads, saved, ctx.needs_input_grad[1:]))


def _dot_dtype(enc_out: torch.Tensor) -> torch.dtype | None:
    """The products' operand type: bf16 for bf16 encoder outputs (as `itrx`
    reaches its kernel only with them, at dot_dtype="bfloat16"), else none
    (no rounding)."""
    return torch.bfloat16 if enc_out.dtype == torch.bfloat16 else None


def vsrn_dec_fused(gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh):
    """The teacher-forced decode: the states hs (T, B, H) in gxw's dtype,
    differentiable in every input but the mask.

    The mode follows enc_out's dtype.  fp32: every operand fp32.  bf16 (the
    train_bf16 step): the operands come as the model holds them, and are
    cast here, differentiably, as `itrx`'s decoder_seq casts them: gxw,
    cmask, enc_att, h0, w2 and bhh to fp32, Watt, Wctx and Whh to bf16;
    the products round their other operand to bf16 (`vsrn_dec_plain`'s
    dot_dtype).  A CPU tensor takes `vsrn_dec_plain` (and
    `vsrn_dec_bwd_plain` in the backward) in the mode's arithmetic; a CUDA
    tensor launches the forward kernel (and the backward kernels) in the
    mode, or raises; any other device raises."""
    out_dtype = gxw.dtype
    dot = _dot_dtype(enc_out)
    if dot is not None:
        gxw, cmask, enc_att, h0, w2, bhh = (t.float() for t in (gxw, cmask, enc_att, h0, w2, bhh))
        watt, wctx, whh = watt.to(dot), wctx.to(dot), whh.to(dot)
    args = (gxw, cmask, enc_out, enc_att, h0, watt, w2, wctx, whh, bhh)
    dev = _guard("vsrn_dec_fused", args, dot)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _VSRNDecode.apply(dot, *args).to(out_dtype)
    with torch.no_grad():
        if dev == "cpu":
            return vsrn_dec_plain(*args, dot_dtype=dot)[0].to(out_dtype)
        return _launch_fwd(*args, residuals=False, dot=dot)[0].to(out_dtype)


# kernel launches since the last reset (each wrapper counts once per call);
# those of the bf16 mode also on their own
vsrn_dec_fused.launches = 0
vsrn_dec_bwd_fused.launches = 0
vsrn_dec_fused.bf16_launches = 0
vsrn_dec_bwd_fused.bf16_launches = 0
