"""The fp32 products of CAMERA's AGSA backward, and its row padding, on the
CPU.

For fp32 inputs the backward kernel (csrc/agsa_attn_bwd.cu, the products in
csrc/agsa_tile.cuh) recomputes the forward chain and runs every product, the
weight sums included, as three TF32 passes on the tensor cores: x = hi + lo
with hi = x with its low 13 mantissa bits cleared and lo the same of x - hi,
and a b = a_hi b_lo + a_lo b_hi + a_hi b_hi with fp32 sums.  Here that
product (the truncation on the uint32 view, exact products summed in
float64, rounded once to fp32) replaces every product inside
`agsa_attention_plain` (the chain the backward recomputes) and
`agsa_attention_bwd_plain`, and the results are held to the plain fp32 pair
within the limits on the card (`chip_smoke.py`'s AGSA_FP32_REL 1e-5 for the
forward chain, AGSA_BWD_REL 1e-4 for each cotangent), at CAMERA's d_k 32 with
N 36, 32, 7 and 64 and at d_k 8 and 128.  Split bf16 (bf16 hi and lo,
rounded to nearest, three passes) reads about ten times worse than three
TF32 passes: the kernel uses TF32.  The kernel pads a head's rows to a
multiple of 16 with zero rows and masks those keys; the plain pair is shown
unchanged by that pad.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from itrx_torch.ops.kernels import agsa_attn

FWD_REL = 1e-5  # chip_smoke.py: AGSA_FP32_REL
BWD_REL = 1e-4  # chip_smoke.py: AGSA_BWD_REL
BWD_NAMES = ("dq", "dk", "dv", "dWq", "dbq", "dWk", "dbk", "dWg1", "dbg1", "dWg2", "dbg2")
MATMUL = torch.Tensor.__matmul__


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x with its low 13 mantissa bits cleared (one TF32 operand), on
    the uint32 view."""
    u = np.ascontiguousarray(x.detach().float().numpy()).view(np.uint32)
    return torch.from_numpy((u & np.uint32(0xFFFFE000)).view(np.float32))


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as the kernel forms them: hi = x truncated to TF32, lo = x -
    hi (exact in fp32) truncated to TF32."""
    hi = _tf32(x)
    return hi, _tf32(x.float() - hi)


def bf16_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of split bf16: hi = x rounded to bf16, lo = x - hi rounded to
    bf16."""
    hi = x.float().to(torch.bfloat16).float()
    return hi, (x.float() - hi).to(torch.bfloat16).float()


def three_pass(split):
    """a @ b as three passes of split operands (hi lo + lo hi + hi hi),
    each product exact, the sums float64, rounded once to fp32."""
    def mm(a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        d = [t.double() for t in (ah, al, bh, bl)]
        return (torch.matmul(d[0], d[3]) + torch.matmul(d[1], d[2])
                + torch.matmul(d[0], d[2])).float()
    return mm


@contextlib.contextmanager
def products(mm):
    """Every `a @ b` of torch tensors computed by mm(a, b) (the plain pair
    writes each of its products, the weight sums included, with @)."""
    torch.Tensor.__matmul__ = lambda a, b: mm(a, b)
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = MATMUL


def _inputs(seed: int, b: int, h: int, n: int, dk: int):
    """q, k, v (B, N, h d_k), the gate's weights at torch's init
    (U(-1/sqrt(d_k), 1/sqrt(d_k)), fc_g's two halves) and biases, and the
    output's cotangent, fp32 from a numpy seed (chip_smoke.py::_agsa_inputs'
    distributions)."""
    rng = np.random.default_rng(seed)
    s = dk ** -0.5

    def t(*shape, u=False):
        x = rng.uniform(-s, s, shape) if u else rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.float32))

    qkv = [t(b, n, h * dk) for _ in range(3)]
    ws = [w for _ in range(4) for w in (t(dk, dk, u=True), t(dk, u=True))]
    return qkv + ws, t(b, n, h * dk)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


CASES = [(4, 3, 36, 32), (4, 3, 32, 32), (5, 2, 7, 32), (3, 2, 64, 32), (4, 3, 36, 8),
         (3, 2, 20, 128)]


@pytest.mark.parametrize("b,h,n,dk", CASES)
def test_three_tf32_passes_hold_the_forward(b, h, n, dk):
    """The forward with every product as three TF32 passes stays within
    AGSA_FP32_REL of the plain fp32 forward."""
    args, _ = _inputs(1, b, h, n, dk)
    want = agsa_attn.agsa_attention_plain(*args, h)
    with products(three_pass(tf32_split)):
        got = agsa_attn.agsa_attention_plain(*args, h)
    err = _rel(got, want)
    print(f"N {n} d_k {dk}: forward three TF32 passes {err:.2e}")
    assert err <= FWD_REL


@pytest.mark.parametrize("b,h,n,dk", CASES)
def test_three_tf32_passes_hold_the_backward(b, h, n, dk):
    """The backward with every product, the weight sums included, as three
    TF32 passes keeps every cotangent within AGSA_BWD_REL of the plain fp32
    backward's."""
    args, g_out = _inputs(2, b, h, n, dk)
    want = agsa_attn.agsa_attention_bwd_plain(*args, g_out, h)
    with products(three_pass(tf32_split)):
        got = agsa_attn.agsa_attention_bwd_plain(*args, g_out, h)
    errs = {name: _rel(a, w) for name, a, w in zip(BWD_NAMES, got, want)}
    print(f"N {n} d_k {dk}: backward three TF32 passes, worst {max(errs.values()):.2e}")
    for name, err in errs.items():
        assert err <= BWD_REL, (name, err)


def test_tf32_split_parts():
    """hi and lo each have their low 13 mantissa bits zero; hi + (x - hi) is
    x exactly, and lo, x - hi cut to TF32, leaves at most 2^-21 of |x| (x -
    hi may carry 13 significant bits, lo keeps 11), always on x's side."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.uniform(-6, 6, 100_000))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    assert torch.equal(hi + (x - hi), x)
    rest = (x.double() - hi.double() - lo.double()) * torch.sign(x.double()) / x.double().abs()
    assert bool((rest >= 0).all()) and bool((rest <= 2.0 ** -21).all())
    assert float(rest.max()) > 0  # lo alone does not give x back


def test_split_bf16_reads_worse_than_three_tf32():
    """At CAMERA's image-tower head (N 36, d_k 32), split bf16 in every
    product of the forward and of the backward reads well above three TF32
    passes (the reason the fp32 kernels use TF32; bf16's hi keeps 8
    significant bits, TF32's 11)."""
    args, g_out = _inputs(4, 8, 4, 36, 32)
    want = agsa_attn.agsa_attention_plain(*args, 4)
    want_b = agsa_attn.agsa_attention_bwd_plain(*args, g_out, 4)
    errs = {}
    for name, split in (("tf32", tf32_split), ("bf16", bf16_split)):
        with products(three_pass(split)):
            fwd = _rel(agsa_attn.agsa_attention_plain(*args, 4), want)
            bwd = max(_rel(a, w) for a, w in
                      zip(agsa_attn.agsa_attention_bwd_plain(*args, g_out, 4), want_b))
        errs[name] = (fwd, bwd)
    print(f"forward, worst cotangent: three TF32 {errs['tf32']}, split bf16 {errs['bf16']}")
    assert errs["bf16"][0] > 4 * errs["tf32"][0]
    assert errs["bf16"][1] > 4 * errs["tf32"][1]


@contextlib.contextmanager
def keys_masked_past(n: int):
    """torch.softmax with every key past the first n at -inf (the kernels'
    mask of a head's padded rows)."""
    softmax = torch.softmax

    def masked(x, dim):
        x = x.clone()
        x[..., n:] = float("-inf")
        return softmax(x, dim=dim)

    torch.softmax = masked
    try:
        yield
    finally:
        torch.softmax = softmax


@pytest.mark.parametrize("n,dt", [(36, torch.float32), (7, torch.float32), (36, torch.bfloat16)])
def test_zero_rows_and_masked_keys_change_nothing(n, dt):
    """A head's rows padded to a multiple of 16 with zero rows whose keys are
    masked (-inf scores) give the plain pair's output and every cotangent at
    the real rows, zero cotangents at the padded rows, and the same weight
    and bias sums: the padded rows add nothing."""
    b, h, dk = 3, 2, 32
    rows = 16 * ((n + 15) // 16)
    args, g_out = _inputs(5, b, h, n, dk)
    args = [t.to(dt) for t in args]
    g_out = g_out.to(dt)

    def pad(x):
        return torch.cat([x, torch.zeros(b, rows - n, h * dk, dtype=x.dtype)], dim=1)

    padded = [pad(t) for t in args[:3]] + args[3:]
    want = agsa_attn.agsa_attention_plain(*args, h)
    want_b = agsa_attn.agsa_attention_bwd_plain(*args, g_out, h)
    with keys_masked_past(n):
        got = agsa_attn.agsa_attention_plain(*padded, h)
        got_b = agsa_attn.agsa_attention_bwd_plain(*padded, pad(g_out), h)
    assert torch.allclose(got[:, :n].float(), want.float(), rtol=0, atol=1e-6)
    for name, a, w in zip(BWD_NAMES, got_b, want_b):
        if name in ("dq", "dk", "dv"):
            assert not a[:, n:].float().any(), name
            a = a[:, :n]
        assert _rel(a, w) <= 1e-6, name


@pytest.mark.parametrize("n,dk,ok", [(64, 8, True), (64, 128, True), (1, 32, True),
                                     (65, 32, False), (36, 136, False), (36, 12, False),
                                     (36, 0, False)])
def test_guard_takes_every_shape_within_limits(n, dk, ok):
    """The kernels' limits are unchanged (N <= 64, 8 <= d_k <= 128, d_k % 8
    == 0, fp32 and bf16): a CUDA call within them passes `_guard`, one
    outside raises there, before anything is built or launched."""

    class Cuda:
        def __init__(self, *shape, dtype=torch.float32):
            self.shape, self.dtype = torch.Size(shape), dtype
            self.device = torch.device("cuda", 0)

    h = 2
    for dt in (torch.float32, torch.bfloat16):
        qkv = [Cuda(3, n, h * max(dk, 1), dtype=dt) for _ in range(3)]
        ws = [Cuda(*s, dtype=dt) for s in ((dk, dk), (dk,)) * 4]
        if ok:
            assert agsa_attn._guard("agsa", *qkv, ws, h) == "cuda"
        else:
            with pytest.raises(ValueError, match="limits"):
                agsa_attn._guard("agsa", *qkv, ws, h)
    assert agsa_attn.within_limits(n, dk) is ok


def test_aligned_copies_only_a_misaligned_tensor():
    """The kernels stage rows with 16-byte copies: `_aligned` passes an
    aligned tensor through and copies one whose data starts off 16 bytes."""
    base = torch.arange(40, dtype=torch.float32)
    assert agsa_attn._aligned(base) is base
    off = base[1:33]
    got = agsa_attn._aligned(off)
    assert got is not off and got.data_ptr() % 16 == 0 and torch.equal(got, off)


def _outside_fma(src: str) -> str:
    """The backward's source without its bf16 section (`namespace fma`, the
    PR 12 design the bf16 mode keeps)."""
    start = src.index("namespace fma {")
    end = src.index("}  // namespace fma", start)
    return src[:start] + src[end:]


def test_agsa_backward_shares_the_tile_header():
    """The AGSA backward includes csrc/agsa_tile.cuh (its fp32 products as
    three TF32 passes on mma.sync) and none of the other kernels' product
    headers; outside its bf16 section (the PR 12 FMA design, kept for bf16)
    it has no fp32-FMA product loop and no g_qm / g_km workspace: two
    launches, the head pass and the ordered reduction.  The forward runs
    fp32 FMAs in the plain version's order (its checks on the card presume
    it): it shares the tile header's staging and helpers and includes no
    other kernel's product header."""
    from itrx_torch.ops import kernels

    header = (kernels.CSRC / "agsa_tile.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert "fmaf(" not in header
    src = (kernels.CSRC / agsa_attn.BWD_SOURCE).read_text()
    assert '#include "agsa_tile.cuh"' in src
    for other in ("xattn_wgmma.cuh", "sgraf_nodes_mma.cuh", "xattn_product.cuh"):
        assert other not in src
    bwd = _outside_fma(src)
    assert "fmaf(" not in bwd
    assert bwd.count("<<<") == 2 and "float* __restrict__ gqm" not in bwd
    fwd = (kernels.CSRC / agsa_attn.SOURCE).read_text()
    assert [line for line in fwd.splitlines() if ".cuh" in line and "#include" in line] == [
        '#include "agsa_tile.cuh"']
