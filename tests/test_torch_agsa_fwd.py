"""CAMERA's AGSA forward kernel around its launch, on the CPU.

The forward (csrc/agsa_attn.cu) keeps the plain version's fp32 order of
operations element by element, so that it equals agsa_attention_plain bit
for bit on the card: fp32 FMAs only, no tensor cores, no fast-math
intrinsics or flags.  Its source and the build flags are read here.  It
stages q, k and v with 16-byte copies, so the wrapper hands it 16-byte
aligned rows: a stand-in for the built library records what the wrapper
passes.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
import torch

from itrx_torch.ops import kernels
from itrx_torch.ops.kernels import agsa_attn as ka


class _StandIn:
    """The two C entries `_launch_fwd` calls (functions, which take the
    ctypes attributes it sets), recording the arguments."""

    def __init__(self):
        self.calls = []

        def fwd(*args):
            self.calls.append([a.value if isinstance(a, ctypes.c_void_p) else a for a in args])
            return 0

        self.itrx_agsa_fwd = fwd
        self.itrx_cuda_error_string = lambda code: b"stand-in"


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte line."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype)
    start = next(i for i in range(1, 4) if (flat.data_ptr() + i * t.element_size()) % 16)
    view = flat[start:start + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.fixture
def launch(monkeypatch):
    """`_launch_fwd` on CPU tensors with the stand-in: the stream query is
    replaced, and the launch counter restored afterwards."""
    monkeypatch.setattr(ka, "current_stream", lambda dev: ctypes.c_void_p(0))
    before = ka.agsa_attention_fused.launches
    lib = _StandIn()
    yield lib
    ka.agsa_attention_fused.launches = before


def _inputs(b=2, n=5, h=2, dk=8, seed=0):
    rng = np.random.default_rng(seed)
    qkv = [torch.from_numpy(rng.standard_normal((b, n, h * dk), dtype=np.float32))
           for _ in range(3)]
    ws = []
    for _ in range(4):
        ws += [torch.from_numpy(rng.standard_normal((dk, dk), dtype=np.float32)),
               torch.from_numpy(rng.standard_normal(dk, dtype=np.float32))]
    return qkv, ws, h


@pytest.mark.parametrize("which", [0, 1, 2])
def test_misaligned_rows_are_copied_to_16_bytes(launch, which):
    (q, k, v), ws, h = _inputs()
    ins = [q, k, v]
    ins[which] = _misaligned(ins[which])
    assert ins[which].data_ptr() % 16
    ka._launch_fwd(*ins, ws, h, lib=launch)
    (call,) = launch.calls
    for i, t in enumerate(ins):
        assert call[i] % 16 == 0
        if i != which:
            assert call[i] == t.data_ptr()  # aligned rows are passed as they are
    assert call[which] != ins[which].data_ptr()
    assert call[12:16] == [2, 5, h, 8] and call[16] == 0  # B, N, H, d_k, fp32


def test_aligned_rows_are_passed_as_they_are(launch):
    (q, k, v), ws, h = _inputs(b=3, n=7, h=3, dk=16, seed=1)
    out = ka._launch_fwd(q, k, v, ws, h, lib=launch)
    (call,) = launch.calls
    assert call[:3] == [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    assert all(p % 16 == 0 for p in call[3:11:2])  # the weights
    assert call[11] == out.data_ptr() and out.shape == q.shape and out.dtype == q.dtype


def test_a_launch_counts_once(launch):
    (q, k, v), ws, h = _inputs()
    before = ka.agsa_attention_fused.launches
    ka._launch_fwd(q, k, v, ws, h, lib=launch)
    ka._launch_fwd(q, k, v, ws, h, lib=launch)
    assert ka.agsa_attention_fused.launches == before + 2 and len(launch.calls) == 2


def _code(src: str) -> str:
    """The source without its comments."""
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def test_forward_source_runs_fmas_in_the_plain_order():
    """The forward includes the shared tile header and holds no tensor-core
    instruction and no fast-math intrinsic, in code or in comments; every
    product of its chains is an explicit fmaf."""
    src = (kernels.CSRC / ka.SOURCE).read_text()
    assert '#include "agsa_tile.cuh"' in src
    for word in (r"\bmma\b", r"\bwgmma\b", r"\bwmma\b", r"__expf", r"__fdividef", r"__fmul_r",
                 r"fast_math", r"__frcp"):
        assert not re.search(word, src), word
    code = _code(src)
    assert "fmaf(" in code and "expf(" in code
    # the helpers come from the header alone
    for helper in ("to_f(float", "from_f<float>", "rnd(float", "sigmoid_f(float"):
        assert helper not in code, helper


@pytest.mark.parametrize("defines", [(), ("ITRX_AGSA_FWD_CUT=1",), ("ITRX_AGSA_FWD_CUT=2",)])
def test_build_flags_keep_ieee_arithmetic(defines):
    flags = kernels._flags(defines)
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    for f in ("-ftz=true", "-prec-div=false", "-prec-sqrt=false"):
        assert f not in flags
    assert "arch=compute_90a,code=sm_90a" in flags


def test_cut_builds_are_libraries_of_their_own():
    """The phase tool's cuts build under their own names: the port's library
    is never a cut."""
    port = kernels.library_path("agsa_attn")
    cuts = {kernels.library_path("agsa_attn", (f"ITRX_AGSA_FWD_CUT={i}",)) for i in (1, 2)}
    assert port not in cuts and len(cuts) == 2
