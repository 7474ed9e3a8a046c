"""Guards of the port: it never imports JAX, its kernel wrappers never fall
back to plain code for a non-CPU tensor, the forward-only xattn kernel is
kept out of training, gradients reach every trained parameter, and its
kernel sources and build directory are where the wrappers and .gitignore
say."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from itrx_torch.models import get_model
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
        "import itrx_torch.utils.convert, itrx_torch.utils.checkpoint, itrx_torch.utils.cli\n"
        "import itrx_torch.ops.losses, itrx_torch.train, itrx_torch.train.state\n"
        "import itrx_torch.train.loop, itrx_torch.train.__main__, itrx_torch.eval.__main__\n"
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


def test_gru_bwd_wrapper_raises_off_cpu():
    before = gru.gru_bwd_fused.launches
    with pytest.raises(ValueError, match="no kernel"):
        gru.gru_bwd_fused(_meta(2, 3, 24), _meta(2, 3), _meta(2, 3, 8), _meta(2, 3, 24),
                          _meta(2, 3, 8), None, _meta(24, 8))
    assert gru.gru_bwd_fused.launches == before


@pytest.mark.parametrize("agg", ["LogSumExp", "Mean"])
def test_xattn_wrapper_raises_off_cpu(agg):
    before = xattn.xattn_t2i_fused.launches
    with pytest.raises(ValueError, match="no kernel"):
        xattn.xattn_t2i_fused(_meta(2, 36, 8), _meta(3, 5, 8), _meta(3, 5), agg_func=agg)
    assert xattn.xattn_t2i_fused.launches == before


@pytest.mark.parametrize("which", ["images", "captions"])
def test_xattn_refuses_to_build_a_graph(which):
    """The kernel is forward-only: with grad enabled it raises on every
    device (here the CPU, whose plain path could differentiate)."""
    g = torch.Generator().manual_seed(0)
    t = {"images": torch.randn(2, 36, 8, generator=g),
         "captions": torch.randn(3, 5, 8, generator=g)}
    t[which].requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only.*plain path"):
        xattn.xattn_t2i_fused(t["images"], t["captions"], torch.ones(3, 5))
    with torch.no_grad():
        assert xattn.xattn_t2i_fused(t["images"], t["captions"], torch.ones(3, 5)).shape == (2, 3)


def _scan(bi_gru=True):
    cfg = dict(name="SCAN", vocab_size=20, img_dim=12, embed_size=16, word_dim=8,
               bi_gru=bi_gru, no_imgnorm=False, no_txtnorm=True,
               precomp_enc_type="basic", margin=0.2, max_violation=True,
               cross_attn="t2i", raw_feature_norm="clipped_l2norm",
               agg_func="LogSumExp", lambda_lse=6.0, lambda_softmax=9.0)
    return get_model(cfg, generator=torch.Generator().manual_seed(0))


def test_scan_sends_only_evaluation_to_the_kernel():
    model = _scan()
    assert model.fused_eval_active(torch.device("cuda", 0))
    assert model.fused_eval_active("cuda", train=False)
    assert not model.fused_eval_active("cuda", train=True)
    assert not model.fused_eval_active("cpu")


@pytest.mark.parametrize("bi_gru", [False, True])
def test_scan_loss_reaches_every_trained_parameter(bi_gru):
    model = _scan(bi_gru)
    g = torch.Generator().manual_seed(1)
    mask = (torch.arange(6)[None] < torch.tensor([6, 1, 3, 4])[:, None]).float()
    batch = {"images": torch.randn(4, 36, 12, generator=g),
             "cap_ids": torch.randint(1, 20, (4, 6), generator=g) * mask.long(),
             "cap_mask": mask}
    loss, _ = model.loss(batch)
    loss.backward()
    names = ["img_enc.fc.weight", "img_enc.fc.bias", "txt_enc.embed.weight"] + [
        f"txt_enc.rnn.{w}_l0{suf}"
        for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
        for suf in (("", "_reverse") if bi_gru else ("",))]
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(names)
    for name in names:
        grad = params[name].grad
        assert grad is not None and grad.abs().sum() > 0, name


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


def test_gru_bwd_source_exists():
    src = kernels.CSRC / gru.BWD_SOURCE
    assert src.exists(), src
    assert "extern \"C\"" in src.read_text()
