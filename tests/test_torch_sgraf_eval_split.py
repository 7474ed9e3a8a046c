"""The split products of the SGRAF evaluation kernels, on the CPU.

The two score kernels (csrc/sgraf_eval_saf.cu, csrc/sgraf_eval_sgr.cu) run
the node projection, the context, the global node and SGR's reasoning
products on the tensor cores as three bf16 passes, a_hi b_lo + a_lo b_hi +
a_hi b_hi with x = hi + lo both bf16 rounded to nearest even
(csrc/sgraf_nodes_mma.cuh).  Here a plain emulation of exactly those
products (the rounding written on the uint32 view; fp32 accumulation)
replaces each of them in the SGRAF eval chain, and the scores are held to
the fp32 plain versions the kernels are held to on the card, within the same
1e-5 (`chip_smoke.py`'s SAF_*_ATOL and SGR_*_ATOL), at the real widths: D
1024, S 256, 36 regions, ragged captions.  The wrapper's weight split is
checked too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from itrx_torch.ops.kernels.sgraf_eval import (LAMBDA_SOFTMAX, NEG_INF, SPLIT_DEPTH, SPLIT_ROWS,
                                               bf16_split, fold_sgr_qk, sgraf_eval_saf_plain,
                                               sgraf_eval_sgr_plain, split_weight)
from itrx_torch.ops.norms import l1norm, l2norm

ATOL = 1e-5  # chip_smoke.py: SAF_FP32_ATOL, SAF_BF16_ATOL, SGR_FP32_ATOL, SGR_BF16_ATOL
D, S, R = 1024, 256, 36


def _bf16(x: np.ndarray) -> np.ndarray:
    """fp32 x rounded to bf16 (8 significant bits), to nearest even, written
    on the uint32 view independently of torch's."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _split(x: torch.Tensor):
    hi = torch.from_numpy(_bf16(x.numpy()))
    return hi, torch.from_numpy(_bf16((x - hi).numpy()))


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it: three split products accumulated in fp32."""
    ah, al = _split(a.float().contiguous())
    bh, bl = _split(b.float().contiguous())
    return (ah @ bl + al @ bh) + ah @ bh


def one_pass_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one bf16 pass would form it."""
    return _split(a.float().contiguous())[0] @ _split(b.float().contiguous())[0]


def _inputs(seed: int, ni: int, nc: int, l: int, bf16: bool, steps: int = 0) -> dict:
    """chip_smoke.py's SAF / SGR inputs from a numpy seed: unit regions,
    tanh captions with ragged lengths (one single-word caption), unit global
    embeddings, xavier-scale weights with small biases; embeddings rounded to
    bf16 values when `bf16` (the kernel's bf16 mode reads those)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    u = lambda r, *sh: t(rng.uniform(-r, r, sh))  # noqa: E731
    img = rng.standard_normal((ni, R, D))
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    lengths = rng.integers(2, l + 1, nc)
    lengths[0] = 1
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    cap = np.tanh(rng.standard_normal((nc, l, D)) * 0.5) * mask[..., None]
    unit = lambda n: (lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True))(  # noqa: E731
        rng.standard_normal((n, D)))
    x = {"cap": t(cap), "mask": t(mask), "img": t(img), "gloc": t(unit(nc)),
         "imgglo": t(unit(ni))}
    if bf16:
        x = {k: v if k == "mask" else v.bfloat16().float() for k, v in x.items()}
    r_loc = np.sqrt(6.0 / (D + S))
    x.update(w=u(r_loc, S, D), b=u(0.05, S), gw=u(r_loc, S, D), gb=u(0.05, S))
    if steps:
        r = np.sqrt(6.0 / (2 * S))
        for k in ("q", "k", "g"):
            x[f"w{k}"], x[f"b{k}"] = u(r, steps, S, S), u(0.05, steps, S)
    else:
        x.update(awf=u(np.sqrt(6.0 / (S + 1)), S), abf=u(0.5, 1))
    x.update(ew=u(np.sqrt(6.0 / (S + 1)), 1, S), eb=u(0.1, 1))
    return x


def _split_nodes(x: dict, split_mm=split_mm):
    """The kernels' nodes with every tensor-core product split: (nodes (C,
    Ni, L + 1, S), global first; their mask (C, 1, L + 1))."""
    cap, m, img = x["cap"], x["mask"], x["img"]
    a = F.leaky_relu(torch.einsum("cld,ird->cilr", cap, img), 0.1) * m[:, None, :, None]
    s = torch.softmax(l2norm(a, dim=2) * LAMBDA_SOFTMAX, dim=3)  # (C, Ni, L, R)
    ctx = split_mm(s, img[None])  # (C, Ni, L, D): sum_r s img_r
    gram = img @ img.transpose(1, 2)
    norm2 = torch.einsum("cilr,irq,cilq->cil", s, gram, s)
    ctx = ctx / (torch.sqrt(norm2.clamp_min(1e-16)) + 1e-8)[..., None]
    loc = l2norm(split_mm((ctx - cap[:, None]) ** 2, x["w"].t()) + x["b"])
    glo = l2norm(split_mm((x["imgglo"][None] - x["gloc"][:, None]) ** 2, x["gw"].t()) + x["gb"])
    nodes = torch.cat([glo[:, :, None], loc], dim=2)
    nmask = torch.cat([torch.ones_like(m[:, :1]), m], dim=1)[:, None]
    return nodes, nmask


def _split_saf(x: dict, split_mm=split_mm) -> torch.Tensor:
    nodes, nmask = _split_nodes(x, split_mm)
    gate = l1norm(torch.sigmoid(nodes @ x["awf"] + x["abf"]) * nmask)
    saf = l2norm(torch.einsum("cin,cins->cis", gate, nodes))
    return torch.sigmoid(F.linear(saf, x["ew"], x["eb"]))[..., 0]


def _split_sgr(x: dict, split_mm=split_mm) -> torch.Tensor:
    """The reasoning with X M + v and ctx Wg + bg split; the edges and
    contexts in fp32, as the kernel's FMAs form them."""
    nodes, nmask = _split_nodes(x, split_mm)
    mm, vv = fold_sgr_qk(x["wq"], x["bq"], x["wk"])
    wg, bg = x["wg"], x["bg"]
    keys = nmask[..., None, :] > 0

    def step(query, i):
        e = (split_mm(query, mm[i]) + vv[i]) @ nodes.transpose(-1, -2)
        a = torch.softmax(e.masked_fill(~keys, NEG_INF), dim=-1)
        return torch.relu(split_mm(a @ nodes, wg[i].t()) + bg[i])

    for i in range(mm.shape[0] - 1):
        nodes = step(nodes, i)
    out = step(nodes[..., :1, :], -1)[..., 0, :]
    return torch.sigmoid(F.linear(out, x["ew"], x["eb"]))[..., 0]


SAF_KEYS = ("cap", "mask", "img", "w", "b", "gloc", "imgglo", "gw", "gb", "awf", "abf", "ew",
            "eb")
SGR_KEYS = ("cap", "mask", "img", "w", "b", "gloc", "imgglo", "gw", "gb", "wq", "bq", "wk",
            "bk", "wg", "bg", "ew", "eb")


@pytest.mark.parametrize("bf16", [False, True])
def test_split_saf_scores_within_the_kernel_limits(bf16):
    x = _inputs(0, 3, 5, 13, bf16)
    want = sgraf_eval_saf_plain(*(x[k] for k in SAF_KEYS))
    got = _split_saf(x)
    assert got.shape == want.shape == (5, 3)
    err = float((got - want).abs().max())
    assert err <= ATOL / 10, err
    # the limit separates: one bf16 pass of the same products misses it
    assert float((_split_saf(x, one_pass_mm) - want).abs().max()) > ATOL


@pytest.mark.parametrize("bf16,steps", [(False, 3), (True, 3), (False, 1)])
def test_split_sgr_scores_within_the_kernel_limits(bf16, steps):
    x = _inputs(1, 3, 4, 11, bf16, steps=steps)
    want = sgraf_eval_sgr_plain(*(x[k] for k in SGR_KEYS))
    got = _split_sgr(x)
    assert got.shape == want.shape == (4, 3)
    assert float((got - want).abs().max()) <= ATOL / 10


def test_bf16_split_of_the_wrapper():
    """hi is bf16(w) rounded to nearest even; hi + lo reconstructs each
    weight within 2^-16 relative."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy((rng.standard_normal((S, D)) * 0.05).astype(np.float32))
    # 1 + 2^-8 is a tie between 1 and 1 + 2^-7: to even, 1
    w[0, :3] = torch.tensor([0.0, 1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8)])
    hi, lo = bf16_split(w)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.float(), torch.from_numpy(_bf16(w.numpy())))
    assert hi[0, 1] == 1.0 and hi[0, 2] == -(1.0 + 2.0 ** -6)
    rel = ((hi.double() + lo.double()) - w.double()).abs() / w.double().abs().clamp_min(1e-30)
    assert float(rel.max()) <= 2.0 ** -16
    assert float((hi.float() - w).abs().max()) > 0  # the split is not the identity


@pytest.mark.parametrize("shape", [(S, D), (3, S, S), (12, 37)])
def test_split_weight_layout(shape):
    """Per slab of 32 k, k16 step and part (hi, lo): core matrices of 8 rows
    x 8 k, [n // 8][k // 8][n % 8][k % 8]; rows padded to 8, depth to 32,
    with zeros."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32))
    out = split_weight(w)
    *lead, n, k = shape
    n8, k32 = -(-n // SPLIT_ROWS) * SPLIT_ROWS, -(-k // SPLIT_DEPTH) * SPLIT_DEPTH
    assert out.shape == (*lead, k32 // 32, 2, 2, n8 // 8, 2, 8, 8)
    assert out.dtype == torch.bfloat16
    for p, part in enumerate(bf16_split(w)):
        full = F.pad(part.float(), (0, k32 - k, 0, n8 - n))
        for slab, st, nb, kg in ((0, 0, 0, 0), (0, 1, 1, 1), (k32 // 32 - 1, 1, n8 // 8 - 1, 0)):
            k0 = 32 * slab + 16 * st + 8 * kg
            want = full[..., 8 * nb:8 * nb + 8, k0:k0 + 8]
            assert torch.equal(out[..., slab, st, p, nb, kg, :, :].float(), want)
    # the permutation loses nothing: every hi and lo value appears once
    every = torch.cat([p.float().flatten() for p in bf16_split(w)])
    kept = out.float().flatten()
    assert torch.equal(kept[kept != 0].sort().values, every[every != 0].sort().values)
