"""SGRAF evaluation scores on the card: the wrappers of
csrc/sgraf_eval_saf.cu (SAF) and csrc/sgraf_eval_sgr.cu (SGR), which share
the node assembly of csrc/sgraf_nodes.cuh.

They replace the TPU kernels itrx/ops/pallas/sgraf_eval.py::_eval_saf_kernel
(wrapper `sgraf_eval_saf_score`) and ::_eval_kernel (`sgraf_eval_score`):
for every (caption, image) pair the whole SGRAF eval chain -- SCAN attention
at lambda 9, the word nodes l2norm(sim_tranloc_w((l2norm(context) -
word)^2)), the global node l2norm(sim_tranglo_w((img_glo - cap_glo)^2)),
then SAF pooling with the eval-mode BatchNorm folded into its gate
(`fold_saf_bn`), or `sgr_step` graph-reasoning steps with the q/k fold
(`fold_sgr_qk`) and the last step trimmed to node 0, and the sim_eval_w +
sigmoid epilogue -- with one fp32 score per pair written to device memory.
What bounds them on an H100: the word nodes' projection, D x S multiply-adds
per valid word (about 78% of SAF's operations at D 1024, S 256), then the A
and context products (36 x D each per word) and the global node (D x S per
pair); SGR adds two S x S products per node and full step (about as many
operations again at three steps).  The kernels read their inputs as they
are (bf16 or fp32) and run the projection, the context, the global node and
SGR's two reasoning products on the tensor cores as split-bf16 products
(csrc/sgraf_nodes_mma.cuh: three bf16 passes, a_hi b_lo + a_lo b_hi + a_hi
b_hi, about 16 bits kept, fp32 accumulation; `wgmma` for the projections
and the reasoning products, `mma.sync` for the context), so the scores stay
within 1e-5 of the fp32 chain; the rest of the chain is fp32.  The weights
are split once per call here (`split_weight`, hi and lo of `bf16_split` in
the layout of the kernels' shared-memory slabs).  The TPU kernels round the
softmax weights, the squared differences, the nodes and S M to bf16 as MXU
operands in one pass; the port does not.

Arguments mirror `sgraf_eval_saf_score` and `sgraf_eval_score` in the
port's layouts: Linear weights as torch stores them, (out, in).  The plain
versions `sgraf_eval_saf_plain` and `sgraf_eval_sgr_plain` run only for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..norms import l1norm, l2norm
from . import check, current_stream, load, ptr

SOURCE = "sgraf_eval_saf.cu"
SGR_SOURCE = "sgraf_eval_sgr.cu"
N_REGIONS = 36
MAX_WORDS = 128
MAX_SIM_DIM = 256
# rows of one SGR block's workspace buffers: 2 images x 128 word columns of
# nodes, then the pairs' global nodes (csrc/sgraf_nodes.cuh::kMaxRows)
WS_ROWS = 2 * MAX_WORDS + 2 * 32
BN_EPS = 1e-5
LAMBDA_SOFTMAX = 9.0
NEG_INF = -1e18
# plain version: budget of one caption chunk's (C, Ni, L, D) fp32 context
PLAIN_CHUNK_BYTES = 1 << 30
# the split weights' padding: rows (output columns) to 8, depth to one slab
# of the kernels (csrc/sgraf_nodes_mma.cuh::kSlab)
SPLIT_ROWS = 8
SPLIT_DEPTH = 32


def bf16_split(x: torch.Tensor) -> tuple:
    """(hi, lo), both bf16 rounded to nearest even: hi = bf16(x), lo =
    bf16(x - hi); hi + lo keeps about 16 bits of x."""
    x = x.float()
    hi = x.bfloat16()
    return hi, (x - hi.float()).bfloat16()


def split_weight(w: torch.Tensor) -> torch.Tensor:
    """The kernels' form of a weight w (..., N, K) laid out [n][k] (output
    column n, depth k), N padded with zero rows to SPLIT_ROWS and K to
    SPLIT_DEPTH: (..., K32 // 32, 2, 2, N8 // 8, 2, 8, 8) bf16.  Per slab
    of 32 k, k16 step st and part (the hi, then the lo of `bf16_split`),
    a K-major matrix of 8-row x 8-k core matrices, [n // 8][k // 8][n %
    8][k % 8]: the shared-memory layout the kernels' tensor-core
    descriptors read, so a slab is one contiguous copy."""
    *lead, n, k = w.shape
    n8, k32 = -(-n // SPLIT_ROWS) * SPLIT_ROWS, -(-k // SPLIT_DEPTH) * SPLIT_DEPTH
    parts = []
    for part in bf16_split(w.detach()):
        part = F.pad(part.float(), (0, k32 - k, 0, n8 - n)).bfloat16()
        # [nb][r][slab][st][kg][e] -> [slab][st][nb][kg][r][e]
        part = part.reshape(*lead, n8 // 8, 8, k32 // 32, 2, 2, 8)
        nd = part.dim()
        order = list(range(nd - 6)) + [nd - 4, nd - 3, nd - 6, nd - 2, nd - 5, nd - 1]
        parts.append(part.permute(order))
    return torch.stack(parts, dim=-5).contiguous()


def fold_saf_bn(attn_w, attn_b, bn_weight, bn_bias, running_mean, running_var):
    """The eval-mode BatchNorm1d(1) after SAF's gate Linear, folded into it
    in fp32 (itrx/models/sgraf.py:361-375): BN(x) = x a' + b' with
    a' = weight / sqrt(var + eps) and b' = bias - mean a'.  attn_w (1, S),
    attn_b (1,) -> (awf (S,), abf (1,))."""
    f = lambda t: t.detach().float()  # noqa: E731
    aprime = f(bn_weight)[0] * torch.rsqrt(f(running_var)[0] + BN_EPS)
    bprime = f(bn_bias)[0] - f(running_mean)[0] * aprime
    return f(attn_w)[0] * aprime, (f(attn_b) * aprime + bprime).reshape(1)


def fold_sgr_qk(wq, bq, wk, dtype: torch.dtype = torch.float32):
    """The q/k fold of SGR's edge logits (itrx/ops/pallas/sgraf_eval.py:
    22-31), in `dtype` (fp32; the training plain pair folds float64 inputs in
    float64), differentiable.  With q = s Wq^T + bq and k = s Wk^T + bk
    (torch's (out, in) layout), e_ij = q_i . k_j = s_i M s_j^T + s_j . v +
    (terms constant along the keys j, which the softmax drops) with
    M = Wq^T Wk and v = Wk^T bq.  wq, wk (..., S, S), bq (..., S) ->
    (M (..., S, S), v (..., S))."""
    wq, bq, wk = (t.to(dtype) for t in (wq, bq, wk))
    return wq.transpose(-1, -2) @ wk, (bq.unsqueeze(-2) @ wk).squeeze(-2)


def _plain_nodes(cp, m, gc, img, imgglo, w, b, gw, gb):
    """One caption chunk's nodes, fp32: (nodes (C, Ni, L + 1, S) with the
    global node first, their mask (C, 1, L + 1))."""
    a = F.leaky_relu(torch.einsum("cld,ird->cilr", cp, img), 0.1) * m[:, None, :, None]
    s = torch.softmax(l2norm(a, dim=2) * LAMBDA_SOFTMAX, dim=3)  # (C, Ni, L, R)
    ctx = l2norm(torch.einsum("cilr,ird->cild", s, img))
    loc = l2norm(F.linear((ctx - cp[:, None]) ** 2, w, b))  # (C, Ni, L, S)
    glo = l2norm(F.linear((imgglo[None] - gc[:, None]) ** 2, gw, gb))  # (C, Ni, S)
    nodes = torch.cat([glo[:, :, None], loc], dim=2)
    nmask = torch.cat([torch.ones_like(m[:, :1]), m], dim=1)[:, None]
    return nodes, nmask


def _plain_chunks(cap, mask, img, gloc, imgglo, weights, score):
    """The fp32 chain over chunks of captions: score(nodes, nmask, *weights)
    of each chunk's nodes -> (Nc, Ni)."""
    cap, img, gloc, imgglo = (t.float() for t in (cap, img, gloc, imgglo))
    mask = mask.float()
    weights = [t.detach().float() for t in weights]
    nc, l, d = cap.shape
    ni = img.shape[0]
    chunk = max(1, PLAIN_CHUNK_BYTES // (ni * l * d * 4))
    out = []
    for c0 in range(0, nc, chunk):
        nodes, nmask = _plain_nodes(cap[c0:c0 + chunk], mask[c0:c0 + chunk],
                                    gloc[c0:c0 + chunk], img, imgglo, *weights[:4])
        out.append(score(nodes, nmask, *weights[4:]))
        del nodes  # free this chunk's tensors before the next is formed
    return torch.cat(out, dim=0).reshape(nc, ni)


def _saf_score(nodes, nmask, awf, abf, ew, eb):
    gate = l1norm(torch.sigmoid(nodes @ awf + abf) * nmask)
    saf = l2norm(torch.einsum("cin,cins->cis", gate, nodes))
    return torch.sigmoid(F.linear(saf, ew, eb))[..., 0]


def sgraf_eval_saf_plain(cap, mask, img, w, b, gloc, imgglo, gw, gb, awf, abf, ew, eb):
    """The same function in plain PyTorch: the fp32 chain on the input
    values, over chunks of captions.  Returns (Nc, Ni) fp32."""
    return _plain_chunks(cap, mask, img, gloc, imgglo, (w, b, gw, gb, awf, abf, ew, eb),
                         _saf_score)


def _sgr_score(nodes, nmask, mm, vv, wg, bg, ew, eb):
    """`steps - 1` full reasoning steps with the folded q/k, the last step
    for query node 0 only (itrx/ops/pallas/sgraf_eval.py::_sgr_step_full,
    ::_sgr_step_node0) and the epilogue."""
    keys = nmask[..., None, :] > 0  # (C, 1, 1, N)
    steps = mm.shape[0]
    for i in range(steps - 1):
        e = (nodes @ mm[i]) @ nodes.transpose(-1, -2) + (nodes @ vv[i])[..., None, :]
        a = torch.softmax(e.masked_fill(~keys, NEG_INF), dim=-1)
        nodes = torch.relu(F.linear(a @ nodes, wg[i], bg[i]))
    s0 = nodes[..., :1, :]  # (C, Ni, 1, S)
    e = (s0 @ mm[-1]) @ nodes.transpose(-1, -2) + (nodes @ vv[-1])[..., None, :]
    a = torch.softmax(e.masked_fill(~keys, NEG_INF), dim=-1)
    out = torch.relu(F.linear((a @ nodes)[..., 0, :], wg[-1], bg[-1]))
    return torch.sigmoid(F.linear(out, ew, eb))[..., 0]


def sgraf_eval_sgr_plain(cap, mask, img, w, b, gloc, imgglo, gw, gb,
                         wq, bq, wk, bk, wg, bg, ew, eb):
    """The same function in plain PyTorch: the fp32 chain on the input
    values with the q/k fold and node 0 trimmed in the last step, over
    chunks of captions.  Returns (Nc, Ni) fp32.  bk drops out of the fold
    (a per-query constant of the edge logits)."""
    mm, vv = fold_sgr_qk(wq, bq, wk)
    return _plain_chunks(cap, mask, img, gloc, imgglo, (w, b, gw, gb, mm, vv, wg, bg, ew, eb),
                         _sgr_score)


def _guard(name, cap, mask, img, w, gloc, imgglo, gw, extra=()) -> str:
    """"cpu" or "cuda" for the wrapper `name`: the kernels are forward-only,
    so with grad enabled and an input that requires grad it raises on every
    device; any device other than the two raises; on a CUDA device every
    shape, type and alignment the kernels do not take raises.  `extra`: the
    reasoning module's weights, held to the same grad and device rules."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (cap, img, w, gloc, imgglo, gw, *extra)
    ):
        raise RuntimeError(
            f"{name}: the kernel is forward-only (it has no backward): SGRAF training "
            "takes the train-mode tower, whose word nodes go to sgraf_align_fused "
            "(ops/kernels/sgraf_align.py)")
    if img.device.type == "cpu":
        return "cpu"
    if img.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {img.device}")
    ni, r, d = img.shape
    nc, l, d2 = cap.shape
    s = w.shape[0]
    if r != N_REGIONS:
        raise ValueError(f"{name}: the kernel takes {N_REGIONS} regions, got {r}")
    if d2 != d or tuple(mask.shape) != (nc, l) or tuple(gloc.shape) != (nc, d) \
            or tuple(imgglo.shape) != (ni, d) or tuple(w.shape) != (s, d) \
            or tuple(gw.shape) != (s, d):
        raise ValueError(f"{name}: shapes of the inputs disagree")
    if not 1 <= l <= MAX_WORDS:
        raise ValueError(f"{name}: caption length {l} not in [1, {MAX_WORDS}]")
    if s > MAX_SIM_DIM or s % 4:
        raise ValueError(f"{name}: sim_dim {s} must be a multiple of 4, at most {MAX_SIM_DIM}")
    if img.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != img.dtype for t in (cap, gloc, imgglo)):
        raise TypeError(f"{name}: embeddings must be all fp32 or all bf16")
    if img.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"{name}: bf16 inputs need D % 8 == 0, got {d}")
    if any(t.device != img.device for t in (cap, mask, w, gloc, imgglo, gw, *extra)):
        raise ValueError(f"{name}: all tensors must be on one device")
    return "cuda"


def _f32(t):
    return t.detach().float().contiguous()


def _node_inputs(name, cap, mask, img, w, b, gloc, imgglo, gw, gb) -> list:
    """The node assembly's kernel arguments, in the order of the C
    interfaces: cap, mask, img, the region Gram, gloc, imgglo (embeddings
    contiguous in their dtype), W and Wg (S, D) split (`split_weight`) and
    the biases, fp32."""
    img, cap, gloc, imgglo = (t.contiguous() for t in (img, cap, gloc, imgglo))
    if img.data_ptr() % 16 or cap.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    im32 = img.float()
    gram = torch.matmul(im32, im32.transpose(1, 2)).contiguous()  # (Ni, 36, 36) fp32
    return [cap, _f32(mask), img, gram, gloc, imgglo,
            split_weight(w), _f32(b), split_weight(gw), _f32(gb)]


def launch_saf(lib, cap, mask, img, w, b, gloc, imgglo, gw, gb, awf, abf, ew, eb):
    """One launch of `lib`'s SAF kernel on CUDA tensors (the arguments of
    `sgraf_eval_saf_fused`), without a guard and without counting it; the
    wrapper's launch, and a measurement build of the same source
    (`load("sgraf_eval_saf", defines)`) launched on the same inputs."""
    ni, _, d = img.shape
    nc, l, _ = cap.shape
    s = w.shape[0]
    out = torch.empty(nc, ni, dtype=torch.float32, device=img.device)
    fn = lib.itrx_sgraf_eval_saf
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launch has been queued
    inputs = _node_inputs("sgraf_eval_saf_fused", cap, mask, img, w, b, gloc, imgglo, gw, gb)
    inputs += [_f32(awf), _f32(abf), _f32(ew), _f32(eb)]
    code = fn(*(ptr(t) for t in inputs), ptr(out), ni, nc, l, d, s,
              int(img.dtype == torch.bfloat16), img.device.index, current_stream(img.device))
    check(lib, "sgraf_eval_saf_kernel", code)
    return out


def sgraf_eval_saf_fused(cap, mask, img, w, b, gloc, imgglo, gw, gb, awf, abf, ew, eb):
    """SGRAF-SAF eval scores, (Nc, Ni) fp32.

    cap (Nc, L, D), mask (Nc, L), img (Ni, 36, D); w (S, D) / b (S,) --
    sim_tranloc_w; gloc (Nc, D) / imgglo (Ni, D) -- the global embeddings;
    gw (S, D) / gb (S,) -- sim_tranglo_w; awf (S,) / abf (1,) -- SAF's gate
    with the BatchNorm folded in (`fold_saf_bn`); ew (1, S) / eb (1,) --
    sim_eval_w.  A CPU tensor takes `sgraf_eval_saf_plain`; a CUDA tensor
    launches the kernel (embeddings fp32 or bf16, products as split bf16,
    fp32 accuracy); any other device raises.  Forward-only: with grad
    enabled and an input that requires grad it raises on every device."""
    args = (cap, mask, img, w, b, gloc, imgglo, gw, gb, awf, abf, ew, eb)
    if _guard("sgraf_eval_saf_fused", cap, mask, img, w, gloc, imgglo, gw) == "cpu":
        return sgraf_eval_saf_plain(*args)
    out = launch_saf(load("sgraf_eval_saf"), *args)
    sgraf_eval_saf_fused.launches += 1
    return out


def sgraf_eval_sgr_fused(cap, mask, img, w, b, gloc, imgglo, gw, gb,
                         wq, bq, wk, bk, wg, bg, ew, eb):
    """SGRAF-SGR eval scores, (Nc, Ni) fp32.

    The node inputs as `sgraf_eval_saf_fused` takes them; wq / bq, wk / bk,
    wg / bg (steps, S, S) / (steps, S) -- the `sgr_step` GraphReasoning
    steps' graph_query_w, graph_key_w and sim_graph_w, stacked; ew (1, S) /
    eb (1,) -- sim_eval_w.  q and k are folded once per call in fp32
    (`fold_sgr_qk`), and the folded M and sim_graph_w split with the node
    weights.  A CPU tensor takes `sgraf_eval_sgr_plain`; a CUDA tensor
    launches the kernel (embeddings fp32 or bf16, products as split bf16,
    fp32 accuracy); any other device raises.  Forward-only: with grad
    enabled and an input that requires grad it raises on every device."""
    name = "sgraf_eval_sgr_fused"
    args = (cap, mask, img, w, b, gloc, imgglo, gw, gb, wq, bq, wk, bk, wg, bg, ew, eb)
    if _guard(name, cap, mask, img, w, gloc, imgglo, gw, extra=(wq, wk, wg)) == "cpu":
        return sgraf_eval_sgr_plain(*args)
    ni, _, d = img.shape
    nc, l, _ = cap.shape
    s = w.shape[0]
    steps = wq.shape[0]
    if steps < 1 or any(tuple(t.shape) != (steps, s, s) for t in (wq, wk, wg)) \
            or any(tuple(t.shape) != (steps, s) for t in (bq, bg)):
        raise ValueError(f"{name}: the reasoning weights must be (steps >= 1, S, S) and "
                         "(steps, S)")
    out = torch.empty(nc, ni, dtype=torch.float32, device=img.device)
    n_ctas = torch.cuda.get_device_properties(img.device).multi_processor_count
    # each block's nodes and one product buffer: the workspace is fixed by
    # the number of blocks, whatever Nc x Ni
    ws = torch.empty(n_ctas, 2, WS_ROWS, s, dtype=torch.float32, device=img.device)
    lib = load("sgraf_eval_sgr")
    fn = lib.itrx_sgraf_eval_sgr
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # every temporary is held by a name until the launch has been queued
    mm, vv = fold_sgr_qk(wq, bq, wk)
    inputs = _node_inputs(name, cap, mask, img, w, b, gloc, imgglo, gw, gb)
    inputs += [split_weight(mm.transpose(1, 2)), vv.contiguous(), split_weight(wg),
               _f32(bg), _f32(ew), _f32(eb)]
    code = fn(*(ptr(t) for t in inputs), ptr(out), ptr(ws), ni, nc, l, d, s, steps,
              int(img.dtype == torch.bfloat16), n_ctas, img.device.index,
              current_stream(img.device))
    check(lib, "sgraf_eval_sgr_kernel", code)
    sgraf_eval_sgr_fused.launches += 1
    return out


# kernel launches since the last reset
sgraf_eval_saf_fused.launches = 0
sgraf_eval_sgr_fused.launches = 0
