"""Guards of the port: it never imports JAX, its kernel wrappers never fall
back to plain code for a non-CPU tensor, and its kernel sources and build
directory are where the wrappers and .gitignore say."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from itrx_torch.ops import kernels
from itrx_torch.ops.kernels import gru, xattn

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import itrx_torch, itrx_torch.eval.engine, itrx_torch.eval.metrics\n"
        "import itrx_torch.models, itrx_torch.models.methods\n"
        "import itrx_torch.ops.attention, itrx_torch.ops.rnn, itrx_torch.ops.norms\n"
        "import itrx_torch.ops.kernels.gru, itrx_torch.ops.kernels.xattn\n"
        "import itrx_torch.utils.convert\n"
        "import itrx.configs, itrx.data.precomp, itrx.data.synthetic\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_gru_wrapper_raises_off_cpu():
    before = gru.gru_scan_fused.launches
    with pytest.raises(ValueError, match="no kernel"):
        gru.gru_scan_fused(_meta(2, 3, 4), _meta(2, 3), _meta(24, 4), _meta(24, 8),
                           _meta(24), _meta(24))
    assert gru.gru_scan_fused.launches == before


@pytest.mark.parametrize("agg", ["LogSumExp", "Mean"])
def test_xattn_wrapper_raises_off_cpu(agg):
    before = xattn.xattn_t2i_fused.launches
    with pytest.raises(ValueError, match="no kernel"):
        xattn.xattn_t2i_fused(_meta(2, 36, 8), _meta(3, 5, 8), _meta(3, 5), agg_func=agg)
    assert xattn.xattn_t2i_fused.launches == before


def test_gitignore_lists_kernel_build_dir():
    rel = kernels.BUILD_DIR.relative_to(REPO)
    lines = (REPO / ".gitignore").read_text().splitlines()
    assert any(rel.as_posix().startswith(ln.strip().strip("/")) for ln in lines
               if ln.strip() and not ln.startswith(("#", "!")))


@pytest.mark.parametrize("module", [gru, xattn])
def test_kernel_sources_exist(module):
    src = kernels.CSRC / module.SOURCE
    assert src.exists(), src
    assert "extern \"C\"" in src.read_text()
