"""Guards of the port: it imports neither JAX nor the JAX package, its
entry points run on the card unless asked for the CPU, its kernel wrappers
never fall back to plain code for a non-CPU tensor, the forward-only xattn
kernels are kept out of training, gradients reach every trained parameter,
and its kernel sources and build directory are where the wrappers and
.gitignore say."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from itrx_torch.eval import engine
from itrx_torch.models import agsa, get_model, methods, sgraf, vsrn_decoder
from itrx_torch.ops import kernels
from itrx_torch.ops.kernels import (agsa_attn, gru, sgr, sgraf_align, sgraf_eval, vsrn_dec,
                                    xattn)
from itrx_torch.train import loop
from itrx_torch.utils.cli import default_device

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


FORBIDDEN = ("itrx", "jax", "jaxlib", "flax", "optax", "ml_dtypes")


def test_port_never_imports_jax():
    """Every module of the port (the `__main__` entry points included) and
    chip_smoke, imported in a fresh interpreter, load no JAX module and no
    module of the JAX package `itrx`."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import itrx_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(itrx_torch.__path__, 'itrx_torch.')]\n"
        "assert len(names) > 30, names\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_import_nothing_of_itrx_or_jax():
    """An AST scan of every port source and chip_smoke.py: no `import itrx`
    / `from itrx` (itrx_torch aside) and no JAX import, at any depth."""
    files = sorted((REPO / "itrx_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


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


@pytest.mark.parametrize("agg", ["LogSumExp", "Mean"])
def test_xattn_i2t_wrapper_raises_off_cpu(agg):
    before = xattn.xattn_i2t_fused.launches
    with pytest.raises(ValueError, match="no kernel"):
        xattn.xattn_i2t_fused(_meta(2, 36, 8), _meta(3, 5, 8), _meta(3, 5), agg_func=agg)
    assert xattn.xattn_i2t_fused.launches == before


@pytest.mark.parametrize("which", ["images", "captions"])
def test_xattn_i2t_refuses_to_build_a_graph(which):
    g = torch.Generator().manual_seed(0)
    t = {"images": torch.randn(2, 36, 8, generator=g),
         "captions": torch.randn(3, 5, 8, generator=g)}
    t[which].requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only.*plain path"):
        xattn.xattn_i2t_fused(t["images"], t["captions"], torch.ones(3, 5))
    with torch.no_grad():
        assert xattn.xattn_i2t_fused(t["images"], t["captions"], torch.ones(3, 5)).shape == (2, 3)


def _cfg(**kw):
    cfg = dict(name="SCAN", vocab_size=20, img_dim=12, embed_size=16, word_dim=8,
               bi_gru=True, no_imgnorm=False, no_txtnorm=True,
               precomp_enc_type="basic", margin=0.2, max_violation=True,
               cross_attn="t2i", raw_feature_norm="clipped_l2norm",
               agg_func="LogSumExp", lambda_lse=6.0, lambda_softmax=9.0)
    cfg.update(kw)
    return cfg


def _scan(bi_gru=True, **kw):
    return get_model(_cfg(bi_gru=bi_gru, **kw), device="cpu",
                     generator=torch.Generator().manual_seed(0))


def test_scan_sends_only_evaluation_to_the_kernel():
    model = _scan()
    assert model.fused_eval_active(torch.device("cuda", 0))
    assert model.fused_eval_active("cuda", train=False)
    assert not model.fused_eval_active("cuda", train=True)
    assert not model.fused_eval_active("cpu")


@pytest.mark.parametrize("direction", ["t2i", "i2t"])
def test_scan_routes_evaluation_by_direction(direction, monkeypatch):
    """With the kernel path active, evaluation goes to the direction's
    kernel wrapper and training to the direction's plain grid."""
    model = _scan(cross_attn=direction, agg_func="Mean")
    calls = []
    for name in ("xattn_t2i_fused", "xattn_i2t_fused"):
        monkeypatch.setattr(methods, name, lambda *a, _n=name, **k: calls.append(_n))
    for name in ("xattn_score_t2i", "xattn_score_i2t"):
        monkeypatch.setattr(methods.attention, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    monkeypatch.setattr(type(model), "fused_eval_active",
                        lambda self, device, train=False: not train)
    img, cap, mask = torch.zeros(2, 36, 16), torch.zeros(3, 4, 16), torch.ones(3, 4)
    model.similarity(img, cap, mask, train=False)
    model.similarity(img, cap, mask, train=True)
    assert calls == [f"xattn_{direction}_fused", f"xattn_score_{direction}"]


def test_scan_i2t_sends_only_evaluation_to_the_kernel():
    model = _scan(cross_attn="i2t", agg_func="Mean", lambda_softmax=4.0)
    assert model.fused_eval_active("cuda", train=False)
    assert not model.fused_eval_active("cuda", train=True)
    assert not model.fused_eval_active("cpu")
    assert not _scan(cross_attn="i2t", agg_func="Max").fused_eval_active("cuda")


def _no_gpu_calls():
    model = _scan()
    cfg = dict(_cfg(), batch_size=4)
    return {
        "get_model": lambda: get_model(cfg),
        "encode_data": lambda: engine.encode_data(model, None, 4),
        "evaluate_split": lambda: engine.evaluate_split(model, None, cfg),
        "evalrank_single": lambda: engine.evalrank_single("missing.pth.tar"),
        "evalrank_ensemble": lambda: engine.evalrank_ensemble("a.pth.tar", "b.pth.tar"),
        "fit": lambda: loop.fit(dict(cfg, resume=None), train_dataset=[], val_dataset=[]),
    }


@pytest.mark.parametrize("entry", ["get_model", "encode_data", "evaluate_split",
                                   "evalrank_single", "evalrank_ensemble", "fit"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a device argument the entry points run on cuda:0; with no GPU
    they raise (no CPU fallback) before touching data or checkpoints."""
    calls = _no_gpu_calls()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        calls[entry]()


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_card_entry_keeps_bf16_products_in_fp32(device, monkeypatch):
    """On the card the entry points make cuBLAS's bf16 products accumulate
    in fp32 throughout (PyTorch's default allows reduced-precision
    reductions), as `itrx`'s bf16 dots do (preferred_element_type fp32);
    the CPU leaves the switch as it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    flag = torch.backends.cuda.matmul
    saved = flag.allow_bf16_reduced_precision_reduction
    try:
        flag.allow_bf16_reduced_precision_reduction = True
        assert default_device("cpu", "test") == torch.device("cpu")
        assert flag.allow_bf16_reduced_precision_reduction
        assert default_device(device, "test").type == "cuda"
        assert not flag.allow_bf16_reduced_precision_reduction
    finally:
        flag.allow_bf16_reduced_precision_reduction = saved


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_card_entry_turns_tf32_off(device, monkeypatch):
    """Every entry point resolves its device through default_device (the
    test above); on the card it leaves fp32 products and convolutions in
    fp32: cuDNN's TF32, on by default, would round the fp32 configurations'
    convolutions (CAMERA's summarization) to a 10-bit mantissa."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        assert default_device(device, "test").type == "cuda"
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        # the CPU leaves them as they are
        torch.backends.cudnn.allow_tf32 = True
        assert default_device("cpu", "test") == torch.device("cpu")
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


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


@pytest.mark.parametrize("module", [gru, xattn, sgraf_eval, sgraf_align, agsa_attn])
def test_kernel_sources_exist(module):
    src = kernels.CSRC / module.SOURCE
    assert src.exists(), src
    assert "extern \"C\"" in src.read_text()


def test_gru_bwd_source_exists():
    src = kernels.CSRC / gru.BWD_SOURCE
    assert src.exists(), src
    assert "extern \"C\"" in src.read_text()


def test_agsa_attn_bwd_source_exists():
    """The AGSA backward's source exists with its C interface: one entry,
    which sizes its own grid within the workspace the wrapper passes."""
    src = (kernels.CSRC / agsa_attn.BWD_SOURCE).read_text()
    assert "int itrx_agsa_bwd(" in src


def test_xattn_i2t_source_exists():
    """Both SCAN kernels include the wgmma product (xattn_wgmma.cuh), not
    the SGRAF kernels' older A product, and neither keeps wmma or the fp32
    FMA product loop."""
    src = kernels.CSRC / xattn.I2T_SOURCE
    assert "int itrx_xattn_i2t(" in src.read_text()
    for name in (xattn.SOURCE, xattn.I2T_SOURCE):
        text = (kernels.CSRC / name).read_text()
        assert '#include "xattn_wgmma.cuh"' in text
        assert "xattn_product.cuh" not in text
    header = (kernels.CSRC / "xattn_wgmma.cuh").read_text()
    assert "wgmma.mma_async" in header and "cp.async.bulk.tensor" in header
    assert "wmma::" not in header and "product_fma" not in header


def test_kernel_build_tracks_the_shared_header(tmp_path, monkeypatch):
    """The library name hashes the shared headers too, so an edited header
    rebuilds both xattn kernels."""
    for name in ("xattn.cu", "xattn_i2t.cu", "xattn_wgmma.cuh"):
        (tmp_path / name).write_text((kernels.CSRC / name).read_text())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = [kernels.library_path(n) for n in ("xattn", "xattn_i2t")]
    (tmp_path / "xattn_wgmma.cuh").write_text("// edited\n")
    after = [kernels.library_path(n) for n in ("xattn", "xattn_i2t")]
    assert all(a != b for a, b in zip(before, after))


@pytest.mark.parametrize("direction", ["t2i", "i2t"])
def test_xattn_guard_refuses_fp32_rows_tma_cannot_stride(direction):
    """The kernels read their rows by TMA (16-byte strides), fp32 inputs as
    fp64 copies: an fp32 call with an odd D raises in the guard, without a
    launch; an even D and any word count in [1, 128] (padded to a multiple
    of 8) pass it."""
    fused = xattn.xattn_t2i_fused if direction == "t2i" else xattn.xattn_i2t_fused
    before = fused.launches
    with pytest.raises(ValueError, match="D % 2"):
        fused(_CudaStandIn(2, 36, 9), _CudaStandIn(3, 5, 9), _CudaStandIn(3, 5))
    assert fused.launches == before
    for l in (1, 21, 128):
        assert xattn._guard("xattn", _CudaStandIn(2, 36, 10), _CudaStandIn(3, l, 10),
                            _CudaStandIn(3, l), "Mean") == "cuda"


def _saf_args(dev="cpu", ni=2, nc=3, l=5, d=8, s=4, **kw):
    g = torch.Generator().manual_seed(0)
    t = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
    args = dict(cap=t(nc, l, d), mask=torch.ones(nc, l, device=dev), img=t(ni, 36, d),
                w=t(s, d), b=t(s), gloc=t(nc, d), imgglo=t(ni, d), gw=t(s, d), gb=t(s),
                awf=t(s), abf=t(1), ew=t(1, s), eb=t(1))
    args.update(kw)
    return args


def _sgr_args(dev="cpu", steps=2, s=4, **kw):
    g = torch.Generator().manual_seed(1)
    t = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
    args = _saf_args(dev, s=s)
    del args["awf"], args["abf"]
    args.update(wq=t(steps, s, s), bq=t(steps, s), wk=t(steps, s, s), bk=t(steps, s),
                wg=t(steps, s, s), bg=t(steps, s))
    args.update(kw)
    return args


def test_sgraf_eval_sgr_wrapper_raises_off_cpu():
    before = sgraf_eval.sgraf_eval_sgr_fused.launches
    with pytest.raises(ValueError, match="no kernel"):
        sgraf_eval.sgraf_eval_sgr_fused(**_sgr_args("meta"))
    assert sgraf_eval.sgraf_eval_sgr_fused.launches == before


@pytest.mark.parametrize("which", ["img", "cap", "wq", "wg"])
def test_sgraf_eval_sgr_refuses_to_build_a_graph(which):
    """Forward-only: with grad enabled and an input (an embedding or a
    reasoning weight) that requires grad it raises on every device (here the
    CPU, whose plain path could differentiate), without counting."""
    args = _sgr_args()
    args[which].requires_grad_()
    before = sgraf_eval.sgraf_eval_sgr_fused.launches
    with pytest.raises(RuntimeError, match="forward-only.*sgraf_align_fused"):
        sgraf_eval.sgraf_eval_sgr_fused(**args)
    with torch.no_grad():
        assert sgraf_eval.sgraf_eval_sgr_fused(**args).shape == (3, 2)
    assert sgraf_eval.sgraf_eval_sgr_fused.launches == before


def test_sgraf_eval_saf_wrapper_raises_off_cpu():
    before = sgraf_eval.sgraf_eval_saf_fused.launches
    with pytest.raises(ValueError, match="no kernel"):
        sgraf_eval.sgraf_eval_saf_fused(**_saf_args("meta"))
    assert sgraf_eval.sgraf_eval_saf_fused.launches == before


@pytest.mark.parametrize("which", ["img", "cap", "w"])
def test_sgraf_eval_saf_refuses_to_build_a_graph(which):
    """Forward-only: with grad enabled and an input that requires grad it
    raises on every device (here the CPU, whose plain path could
    differentiate), without counting."""
    args = _saf_args()
    args[which].requires_grad_()
    before = sgraf_eval.sgraf_eval_saf_fused.launches
    with pytest.raises(RuntimeError, match="forward-only.*sgraf_align_fused"):
        sgraf_eval.sgraf_eval_saf_fused(**args)
    with torch.no_grad():
        assert sgraf_eval.sgraf_eval_saf_fused(**args).shape == (3, 2)
    assert sgraf_eval.sgraf_eval_saf_fused.launches == before


def _sgraf(**kw):
    cfg = dict(_cfg(), name="SGRAF", sim_dim=8, module_name="SAF", sgr_step=3, cap_chunk=2)
    cfg.update(kw)
    return get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def test_sgraf_sends_only_evaluation_to_the_kernel(monkeypatch):
    """Evaluation on the card goes to the kernel wrapper (the BatchNorm
    folded into the gate); on the CPU to the plain chain; training never
    reaches the eval kernel, and a `train` flag that disagrees with the
    module's mode raises."""
    model = _sgraf()
    assert model.fused_eval_active(torch.device("cuda", 0))
    assert model.fused_eval_active("cuda", train=False)
    assert not model.fused_eval_active("cuda", train=True)
    assert not model.fused_eval_active("cpu")
    calls = []
    monkeypatch.setattr(sgraf, "sgraf_eval_saf_fused",
                        lambda *a: calls.append(len(a)) or torch.zeros(3, 2))
    monkeypatch.setattr(type(model), "fused_eval_active",
                        lambda self, device, train=False: not train)
    img, cap, mask = torch.zeros(2, 36, 16), torch.zeros(3, 4, 16), torch.ones(3, 4)
    assert model.similarity(img, cap, mask).shape == (2, 3)
    assert calls == [13]
    with pytest.raises(ValueError, match="model.train"):
        model.similarity(img, cap, mask, train=True)
    model.train()
    assert model.similarity(img, cap, mask, train=True).shape == (2, 3)
    assert calls == [13]


def test_sgraf_sgr_sends_only_evaluation_to_the_kernel(monkeypatch):
    """SGR's evaluation on the card goes to the SGR kernel wrapper with the
    steps' Linears stacked (the SAF wrapper never); on the CPU to the plain
    chain; training never reaches an eval kernel, and asking for one in
    train mode raises."""
    model = _sgraf(module_name="SGR", sgr_step=2)
    assert model.fused_eval_active("cuda", train=False)
    assert not model.fused_eval_active("cuda", train=True)
    assert not model.fused_eval_active("cpu")
    calls = []

    def sgr(*a):
        calls.append(("sgr", [tuple(t.shape) for t in a[9:15]]))
        return torch.zeros(3, 2)

    monkeypatch.setattr(sgraf, "sgraf_eval_sgr_fused", sgr)
    monkeypatch.setattr(sgraf, "sgraf_eval_saf_fused", lambda *a: calls.append(("saf",)))
    monkeypatch.setattr(type(model), "fused_eval_active",
                        lambda self, device, train=False: not train)
    img, cap, mask = torch.zeros(2, 36, 16), torch.zeros(3, 4, 16), torch.ones(3, 4)
    with torch.no_grad():
        assert model.similarity(img, cap, mask).shape == (2, 3)
    assert calls == [("sgr", [(2, 8, 8), (2, 8)] * 3)]
    model.train()
    assert model.similarity(img, cap, mask, train=True).shape == (2, 3)
    assert model.sim_enc(img, cap, mask).shape == (2, 3)
    with pytest.raises(ValueError, match="evaluation only"):
        model.sim_enc(img, cap, mask, kernel=True)
    assert len(calls) == 1


def test_sgraf_refuses_an_unknown_module():
    with pytest.raises(ValueError, match="module_name"):
        _sgraf(module_name="SAGR")
    with pytest.raises(ValueError, match="sgr_step"):
        _sgraf(module_name="SGR", sgr_step=0)


def test_sgraf_saf_training_names_its_roadmap_item():
    """SAF trains (its BatchNorm takes the chunk's per-caption statistics);
    SGR trains too (its training item, 8d, is done): the train-mode tower
    gives the grid and a loss whose gradient reaches every step."""
    model = _sgraf()
    nodes, nmask = torch.randn(4, 3, 8), torch.ones(4, 3)
    saf = model.sim_enc.SAF_module.train()
    assert saf(nodes, nmask, cap_rows=2).shape == (4, 8)
    assert int(saf.bn.num_batches_tracked) == 2 and float(saf.bn.running_var) != 1.0
    sgr = _sgraf(module_name="SGR").train()
    grid = sgr.sim_enc(torch.randn(2, 36, 16), torch.randn(3, 4, 16), torch.ones(3, 4))
    assert grid.shape == (2, 3)
    grid.sum().backward()
    assert all(p.grad is not None for p in sgr.sim_enc.SGR_module.parameters())


def test_check_supported_refuses_sgraf_training():
    """check_supported accepts all six methods: SGRAF with SAF and with SGR,
    VSRN, CAMERA, SCAN, VSE++ on precomputed features and SAEM, with
    train_bf16 too; it still refuses VSE++ on raw images (ROADMAP item 12)
    and meshes (item 13)."""
    loop.check_supported(dict(_cfg(), name="SGRAF", module_name="SAF"))
    loop.check_supported(dict(_cfg(), name="SGRAF", module_name="SGR"))
    loop.check_supported(dict(_cfg(), name="VSRN"))
    loop.check_supported(dict(_cfg(), name="CAMERA"))
    loop.check_supported(_cfg())
    for name in ("VSE_PP", "VSE++", "SAEM"):
        loop.check_supported(dict(_cfg(), name=name, data_name="f30k_precomp"))
    for data_name in ("coco", "f8k", "f30k"):
        with pytest.raises(NotImplementedError, match="raw images.*ROADMAP queue 1 item 12"):
            loop.check_supported(dict(_cfg(), name="VSE_PP", data_name=data_name))
    loop.check_supported(dict(_cfg(), name="SAEM", train_bf16=True))
    with pytest.raises(NotImplementedError, match="mesh_shape.*item 13"):
        loop.check_supported(dict(_cfg(), name="VSE_PP", mesh_shape=[2]))
    loop.check_supported(dict(_cfg(), name="CAMERA", train_bf16=True))
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        loop.check_supported(dict(_cfg(), name="SGRAF", module_name="SGR", mesh_shape=[2]))


def _align_args(dev="cpu", nc=3, ni=2, l=5, d=16, s=8):
    g = torch.Generator().manual_seed(2)
    t = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
    return dict(cap=t(nc, l, d), mask=torch.ones(nc, l, device=dev), img=t(ni, 36, d),
                w=t(s, d), b=t(s))


def test_sgraf_align_wrappers_raise_off_cpu():
    """The alignment wrappers (forward and backward) raise on a device that
    is neither the CPU nor CUDA, without counting, grad or no grad."""
    before = (sgraf_align.sgraf_align_fused.launches,
              sgraf_align.sgraf_align_bwd_fused.launches)
    args = _align_args("meta")
    with pytest.raises(ValueError, match="no kernel"):
        sgraf_align.sgraf_align_fused(**args)
    args["w"].requires_grad_()
    with pytest.raises(ValueError, match="no kernel"):
        sgraf_align.sgraf_align_fused(**args)
    with pytest.raises(ValueError, match="no kernel"):
        sgraf_align.sgraf_align_bwd_fused(**_align_args("meta"), g=torch.zeros(3, 2, 5, 8,
                                                                             device="meta"))
    assert (sgraf_align.sgraf_align_fused.launches,
            sgraf_align.sgraf_align_bwd_fused.launches) == before


@pytest.mark.parametrize("sim_bf16", [True, False])
def test_sgraf_saf_training_routes_the_chain_by_sim_bf16(monkeypatch, sim_bf16):
    """SGRAF-SAF training sends each chunk's word nodes to sgraf_align_fused
    (bf16 embeddings, the sim_tranloc_w Linear) when sim_bf16, and never
    without it (the plain chain, as `itrx` runs its XLA chain); neither
    route reaches an eval kernel, and every trained parameter gets a
    gradient."""
    calls = []
    real = sgraf.sgraf_align_fused

    def spy(cap, mask, img, w, b):
        calls.append((tuple(cap.shape), cap.dtype, img.dtype, w.requires_grad))
        return real(cap, mask, img, w, b)

    monkeypatch.setattr(sgraf, "sgraf_align_fused", spy)
    for name in ("sgraf_eval_saf_fused", "sgraf_eval_sgr_fused"):
        monkeypatch.setattr(sgraf, name, lambda *a: pytest.fail("eval kernel in training"))
    model = _sgraf(sim_bf16=sim_bf16, cap_chunk=2).train()
    g = torch.Generator().manual_seed(0)
    batch = {"images": torch.randn(3, 36, 12, generator=g),
             "cap_ids": torch.randint(1, 20, (3, 4), generator=g),
             "cap_mask": torch.tensor([[1.0, 1, 1, 1], [1, 0, 0, 0], [1, 1, 0, 0]])}
    loss, _ = model.loss(batch)
    loss.backward()
    if sim_bf16:
        assert calls == [((2, 4, 16), torch.bfloat16, torch.bfloat16, True),
                         ((1, 4, 16), torch.bfloat16, torch.bfloat16, True)]
    else:
        assert calls == []
    assert all(p.grad is not None for p in model.parameters())


def test_sgraf_align_sources_are_built_and_hashed(tmp_path, monkeypatch):
    """The forward and backward kernels exist with their C interfaces; both
    include the node assembly (and through it the A product) and the split
    tensor-core products, and both library names change when their source
    or a shared header changes."""
    fwd, bwd = (kernels.CSRC / n for n in (sgraf_align.SOURCE, sgraf_align.BWD_SOURCE))
    assert "int itrx_sgraf_align(" in fwd.read_text()
    assert "int itrx_sgraf_align_bwd(" in bwd.read_text()
    for src in (fwd, bwd):
        for header in ("sgraf_nodes.cuh", "sgraf_nodes_mma.cuh"):
            assert f'#include "{header}"' in src.read_text()
    headers = ("sgraf_nodes_mma.cuh", "sgraf_nodes.cuh", "xattn_product.cuh")
    for name in (sgraf_align.SOURCE, sgraf_align.BWD_SOURCE) + headers:
        (tmp_path / name).write_text((kernels.CSRC / name).read_text())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    libs = ("sgraf_align", "sgraf_align_bwd")
    seen = [[kernels.library_path(n) for n in libs]]
    for edited in headers + (sgraf_align.SOURCE, sgraf_align.BWD_SOURCE):
        (tmp_path / edited).write_text("// edited\n")
        seen.append([kernels.library_path(n) for n in libs])
    assert len({paths[0] for paths in seen}) == 5  # the forward: all but bwd's source
    assert len({paths[1] for paths in seen}) == 5  # the backward: all but fwd's source


def test_sgraf_align_bwd_sources_are_built_and_hashed(tmp_path, monkeypatch):
    """The backward's C entry exists; it includes the node assembly and the
    split tensor-core products (which include the A product), no longer the
    fp32-FMA tile product of gemm_tile.cuh; and its library name changes when
    its source or any header it includes changes, and not when another
    kernel's source does."""
    bwd = kernels.CSRC / sgraf_align.BWD_SOURCE
    text = bwd.read_text()
    assert "int itrx_sgraf_align_bwd(" in text
    for header in ("sgraf_nodes.cuh", "sgraf_nodes_mma.cuh"):
        assert f'#include "{header}"' in text
    assert '#include "gemm_tile.cuh"' not in text
    headers = ("sgraf_nodes_mma.cuh", "sgraf_nodes.cuh", "xattn_product.cuh")
    for name in (sgraf_align.BWD_SOURCE, sgraf_align.SOURCE) + headers:
        (tmp_path / name).write_text((kernels.CSRC / name).read_text())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    seen = [kernels.library_path("sgraf_align_bwd")]
    for edited in headers + (sgraf_align.BWD_SOURCE,):
        (tmp_path / edited).write_text("// edited\n")
        seen.append(kernels.library_path("sgraf_align_bwd"))
    assert len(set(seen)) == 2 + len(headers)
    (tmp_path / sgraf_align.SOURCE).write_text("// edited\n")
    assert kernels.library_path("sgraf_align_bwd") == seen[-1]


@pytest.mark.parametrize("sim_bf16", [True, False])
def test_sgraf_sgr_training_routes_the_reasoning_by_sim_bf16(monkeypatch, sim_bf16):
    """SGRAF-SGR training sends each chunk's reasoning steps to
    sgr_reason_fused (the fp32 nodes, the node mask and the steps' Linears
    stacked, under grad) when sim_bf16, beside the word nodes to
    sgraf_align_fused; without sim_bf16 neither wrapper is called (the
    GraphReasoning module loop, as `itrx` runs its XLA chain).  No route
    reaches an eval kernel, and every trained parameter gets a gradient."""
    calls = []
    real = sgraf.sgr_reason_fused

    def spy(s0, mask, *w):
        calls.append((tuple(s0.shape), s0.dtype, tuple(mask.shape),
                      [tuple(t.shape) for t in w], all(t.requires_grad for t in w)))
        return real(s0, mask, *w)

    monkeypatch.setattr(sgraf, "sgr_reason_fused", spy)
    aligned = []
    real_align = sgraf.sgraf_align_fused
    monkeypatch.setattr(sgraf, "sgraf_align_fused",
                        lambda *a: aligned.append(1) or real_align(*a))
    for name in ("sgraf_eval_saf_fused", "sgraf_eval_sgr_fused"):
        monkeypatch.setattr(sgraf, name, lambda *a: pytest.fail("eval kernel in training"))
    model = _sgraf(module_name="SGR", sgr_step=2, sim_bf16=sim_bf16, cap_chunk=2).train()
    g = torch.Generator().manual_seed(0)
    batch = {"images": torch.randn(3, 36, 12, generator=g),
             "cap_ids": torch.randint(1, 20, (3, 4), generator=g),
             "cap_mask": torch.tensor([[1.0, 1, 1, 1], [1, 0, 0, 0], [1, 1, 0, 0]])}
    loss, _ = model.loss(batch)
    loss.backward()
    if sim_bf16:
        w = [(2, 8, 8), (2, 8)] * 3
        assert calls == [((6, 5, 8), torch.float32, (6, 5), w, True),
                         ((3, 5, 8), torch.float32, (3, 5), w, True)]
        assert aligned == [1, 1]
    else:
        assert calls == [] and aligned == []
    assert all(p.grad is not None for p in model.parameters())


def _reason_args(dev="cpu", b=3, n=4, s=8, steps=2):
    g = torch.Generator().manual_seed(3)
    t = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
    return dict(s0=t(b, n, s), mask=torch.ones(b, n, device=dev), wq=t(steps, s, s),
                bq=t(steps, s), wk=t(steps, s, s), bk=t(steps, s), wg=t(steps, s, s),
                bg=t(steps, s))


def test_sgr_wrappers_raise_off_cpu():
    """The reasoning wrappers (forward, the forward with its saves, and
    backward) raise on a device that is neither the CPU nor CUDA, without
    counting, grad or no grad."""
    before = (sgr.sgr_reason_fused.launches, sgr.sgr_reason_bwd_fused.launches)
    args = _reason_args("meta")
    with pytest.raises(ValueError, match="no kernel"):
        sgr.sgr_reason_fused(**args)
    with pytest.raises(ValueError, match="no kernel"):
        sgr.sgr_reason_fwd_fused(**args)
    args["wg"].requires_grad_()
    with pytest.raises(ValueError, match="no kernel"):
        sgr.sgr_reason_fused(**args)
    with pytest.raises(ValueError, match="no kernel"):
        sgr.sgr_reason_bwd_fused(**_reason_args("meta"),
                                 outs=torch.zeros(2, 3, 4, 8, device="meta"),
                                 g=torch.zeros(3, 4, 8, device="meta"))
    assert (sgr.sgr_reason_fused.launches, sgr.sgr_reason_bwd_fused.launches) == before


def test_sgr_sources_are_built_and_hashed(tmp_path, monkeypatch):
    """The forward and backward kernels exist with their C interfaces, both
    include the listed-row helpers (the split tensor-core row tiles, the
    plan kernel) and the split tensor-core products; no source keeps an
    fp32-FMA tile product (gemm_tile.cuh, tile_product, the SGR forward's
    rows_kernel); and
    both library names change when their source or a header they include
    changes."""
    fwd, bwd = (kernels.CSRC / n for n in (sgr.SOURCE, sgr.BWD_SOURCE))
    assert "int itrx_sgr_fwd(" in fwd.read_text()
    assert "int itrx_sgr_plan(" in fwd.read_text()
    assert "int itrx_sgr_bwd(" in bwd.read_text()
    for src in (fwd, bwd):
        assert '#include "sgr_rows.cuh"' in src.read_text()
        assert '#include "sgraf_nodes_mma.cuh"' in src.read_text()
        assert '#include "gemm_tile.cuh"' not in src.read_text()
    assert all("tile_product" not in src.read_text() for src in kernels.CSRC.iterdir())
    assert not any(re.search(r"\brows_kernel\b", (kernels.CSRC / n).read_text())
                   for n in (sgr.SOURCE, sgr.BWD_SOURCE, "sgr_rows.cuh"))
    assert '#include "sgraf_nodes.cuh"' in (kernels.CSRC / "sgr_rows.cuh").read_text()
    headers = ("sgr_rows.cuh", "sgraf_nodes_mma.cuh", "sgraf_nodes.cuh", "xattn_product.cuh")
    for name in (sgr.SOURCE, sgr.BWD_SOURCE) + headers:
        (tmp_path / name).write_text((kernels.CSRC / name).read_text())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    libs = ("sgr", "sgr_bwd")
    seen = [[kernels.library_path(n) for n in libs]]
    for edited in headers + (sgr.SOURCE, sgr.BWD_SOURCE):
        (tmp_path / edited).write_text("// edited\n")
        seen.append([kernels.library_path(n) for n in libs])
    assert len({paths[0] for paths in seen}) == 6  # the forward: all but bwd's source
    assert len({paths[1] for paths in seen}) == 6  # the backward: all but fwd's source


def test_sgraf_eval_saf_source_is_built_and_hashed(tmp_path, monkeypatch):
    """The SAF kernel's library name hashes its source and the shared headers
    it includes: the node assembly, which includes the A product."""
    src = kernels.CSRC / sgraf_eval.SOURCE
    assert "int itrx_sgraf_eval_saf(" in src.read_text()
    assert '#include "sgraf_nodes.cuh"' in src.read_text()
    assert '#include "xattn_product.cuh"' in (kernels.CSRC / "sgraf_nodes.cuh").read_text()
    for name in (sgraf_eval.SOURCE, "xattn_product.cuh", "sgraf_nodes.cuh"):
        (tmp_path / name).write_text((kernels.CSRC / name).read_text())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    first = kernels.library_path("sgraf_eval_saf")
    (tmp_path / "xattn_product.cuh").write_text("// edited\n")
    second = kernels.library_path("sgraf_eval_saf")
    (tmp_path / sgraf_eval.SOURCE).write_text("// edited\n")
    assert len({first, second, kernels.library_path("sgraf_eval_saf")}) == 3


def test_sgraf_eval_sgr_source_is_built_and_hashed(tmp_path, monkeypatch):
    """The SGR kernel exists, shares the node assembly and split-product
    headers with the SAF kernel, and its library name (and the SAF kernel's)
    changes when any shared header changes."""
    src = kernels.CSRC / sgraf_eval.SGR_SOURCE
    assert "int itrx_sgraf_eval_sgr(" in src.read_text()
    assert '#include "sgraf_nodes.cuh"' in src.read_text()
    headers = ("sgraf_nodes_mma.cuh", "sgraf_nodes.cuh", "xattn_product.cuh")
    for source in (sgraf_eval.SOURCE, sgraf_eval.SGR_SOURCE):
        assert '#include "sgraf_nodes_mma.cuh"' in (kernels.CSRC / source).read_text()
    names = (sgraf_eval.SOURCE, sgraf_eval.SGR_SOURCE) + headers
    for name in names:
        (tmp_path / name).write_text((kernels.CSRC / name).read_text())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    libs = ("sgraf_eval_saf", "sgraf_eval_sgr")
    seen = [[kernels.library_path(n) for n in libs]]
    for header in headers:
        (tmp_path / header).write_text("// edited\n")
        seen.append([kernels.library_path(n) for n in libs])
    for i, _ in enumerate(libs):
        assert len({paths[i] for paths in seen}) == 1 + len(headers)
    # a variant built with a define for a measurement has a name of its own
    assert kernels.library_path("sgraf_eval_saf", ("ITRX_SAF_NO_POOL",)) \
        != kernels.library_path("sgraf_eval_saf")


def _dec_args(dev="cpu", t=3, b=2, r=4, h=8):
    g = torch.Generator().manual_seed(3)
    x = lambda *sh: (torch.randn(*sh, generator=g) * 0.3).to(dev)  # noqa: E731
    return (x(t, b, 3 * h), torch.ones(t, b, h, device=dev), x(b, r, h), x(b, r, h), x(b, h),
            x(h, h), x(1, h), x(3 * h, h), x(3 * h, h), x(3 * h))


def test_vsrn_dec_wrappers_raise_off_cpu_and_cuda():
    """The decoder wrappers raise for a tensor on neither the CPU nor a CUDA
    device, with and without grad, without counting a launch."""
    before = vsrn_dec.vsrn_dec_fused.launches, vsrn_dec.vsrn_dec_bwd_fused.launches
    args = _dec_args("meta")
    with pytest.raises(ValueError, match="no kernel"):
        vsrn_dec.vsrn_dec_fused(*args)
    args[5].requires_grad_()
    with pytest.raises(ValueError, match="no kernel"):
        vsrn_dec.vsrn_dec_fused(*args)
    res = [torch.zeros(3, 2, 8, device="meta"), torch.zeros(3, 2, 24, device="meta"),
           torch.zeros(3, 2, 8, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        vsrn_dec.vsrn_dec_bwd_fused(*_dec_args("meta"), *res)
    assert (vsrn_dec.vsrn_dec_fused.launches, vsrn_dec.vsrn_dec_bwd_fused.launches) == before


def test_bf16_modes_count_only_where_they_launch():
    """The GRU adjoint's and the decoder pair's bf16 modes count their
    launches also on their own (`bf16_launches`, at the launch alone): bf16
    calls on the CPU, the decoder's with grad through its backward, count
    none."""
    fns = (gru.gru_bwd_fused, vsrn_dec.vsrn_dec_fused, vsrn_dec.vsrn_dec_bwd_fused)
    before = [(f.launches, f.bf16_launches) for f in fns]
    assert all(isinstance(n, int) for pair in before for n in pair)
    g = torch.Generator().manual_seed(5)
    b, l, h = 2, 3, 4
    gates_x, hall = torch.randn(b, l, 3 * h, generator=g), torch.randn(b, l, h, generator=g)
    gru.gru_bwd_fused(gates_x, torch.ones(b, l), hall, torch.randn(b, l, 3 * h, generator=g),
                      torch.randn(b, l, h, generator=g), None,
                      torch.randn(3 * h, h, generator=g).bfloat16())
    args = list(_dec_args())
    args[2] = args[2].bfloat16()
    args[5].requires_grad_()
    vsrn_dec.vsrn_dec_fused(*args).sum().backward()
    assert args[5].grad is not None
    assert [(f.launches, f.bf16_launches) for f in fns] == before


def _vsrn(**kw):
    cfg = dict(_cfg(), name="VSRN", embed_size=16, data_name="f30k_precomp",
               measure="cosine", use_abs=False, max_len=5, dim_hidden=8, dim_vid=16,
               dim_word=8, input_dropout_p=0.2)
    cfg.update(kw)
    return get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def _vsrn_batch(b=3, l=6):
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(1, 20, (b, l), generator=g)
    return {"images": torch.randn(b, 5, 12, generator=g), "cap_ids": ids,
            "cap_mask": torch.ones(b, l), "label_ids": ids, "label_mask": torch.ones(b, l)}


def test_vsrn_training_reaches_the_decoder_wrapper(monkeypatch):
    """VSRN's train-mode loss sends the decode loop to vsrn_dec_fused, once,
    with grad (so the autograd Function and, on the card, both kernels run),
    and its gradient reaches every parameter; VSRN.loss refuses a `train`
    flag that disagrees with the module's mode."""
    calls = []

    def counting(*a):
        calls.append(torch.is_grad_enabled() and any(t.requires_grad for t in a))
        return vsrn_dec.vsrn_dec_fused(*a)

    monkeypatch.setattr(vsrn_decoder, "vsrn_dec_fused", counting)
    model = _vsrn().train()
    loss, aux = model.loss(_vsrn_batch())
    assert calls == [True] and sorted(aux) == ["Loss", "Loss_caption", "Loss_retrieval"]
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    with pytest.raises(ValueError, match="model.train"):
        model.eval().loss(_vsrn_batch())


def test_vsrn_evaluation_reaches_no_grid_kernel(monkeypatch):
    """VSRN's evaluation runs no kernel but the GRU's: fused_eval_active is
    False on every device, eval-mode embed keeps no GCN sequence and never
    runs the caption decoder, and cal_sims takes the 2-D grid."""
    def refuse(*a, **k):
        raise AssertionError("an evaluation reached a kernel wrapper")

    for mod, name in ((vsrn_decoder, "vsrn_dec_fused"), (methods, "xattn_t2i_fused"),
                      (methods, "xattn_i2t_fused")):
        monkeypatch.setattr(mod, name, refuse)
    model = _vsrn().eval()
    for dev in ("cpu", "cuda"):
        assert not model.fused_eval_active(torch.device(dev), train=False)
    with torch.no_grad():
        e = model.embed(_vsrn_batch())
    assert sorted(e) == ["cap", "img"]
    assert engine.cal_sims(model, e["img"], e["cap"], verbose=False).shape == (3, 3)


def test_vsrn_dec_sources_are_built_and_hashed(tmp_path, monkeypatch):
    """The decoder's forward and backward kernels exist with their C
    interfaces, both include the shared attention header, the persistent
    loops' shared pieces (the split tensor-core product, which includes the
    grid barrier and the split) and the grid barrier, the backward also the
    wgmma products; no source keeps a copy of the loop's product, and no
    header the fp32-FMA tile product (gemm_tile.cuh is gone); and both
    library names change when any of those headers changes."""
    fwd, bwd = (kernels.CSRC / n for n in (vsrn_dec.SOURCE, vsrn_dec.BWD_SOURCE))
    assert "int itrx_vsrn_dec_fwd(" in fwd.read_text()
    assert "int itrx_vsrn_dec_bwd(" in bwd.read_text()
    loop = ("vsrn_dec.cuh", "vsrn_dec_loop.cuh", "gru_persistent.cuh")
    includes = {fwd: loop, bwd: loop + ("sgraf_nodes_mma.cuh",),
                kernels.CSRC / "vsrn_dec_loop.cuh": ("gru_persistent.cuh", "sgraf_nodes_mma.cuh")}
    for src, names in includes.items():
        assert all(f'#include "{h}"' in src.read_text() for h in names)
    for src in (fwd, bwd):
        assert "product_mma(float" not in src.read_text()
    assert not (kernels.CSRC / "gemm_tile.cuh").exists()
    assert all("gemm_tile" not in h.read_text() for h in kernels.CSRC.glob("*.cu*"))
    headers = ("vsrn_dec.cuh", "vsrn_dec_loop.cuh", "gru_persistent.cuh", "sgraf_nodes_mma.cuh")
    for name in (vsrn_dec.SOURCE, vsrn_dec.BWD_SOURCE) + headers:
        (tmp_path / name).write_text((kernels.CSRC / name).read_text())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    libs = ("vsrn_dec", "vsrn_dec_bwd")
    seen = [[kernels.library_path(n) for n in libs]]
    for edited in headers:
        (tmp_path / edited).write_text("// edited\n")
        seen.append([kernels.library_path(n) for n in libs])
    for i, _ in enumerate(libs):
        assert len({paths[i] for paths in seen}) == 1 + len(headers)


class _CudaStandIn:
    """A stand-in for a CUDA tensor (this machine has no card): the device,
    shape, dtype and grad flag the AGSA wrapper's guard reads."""

    def __init__(self, *shape, requires_grad=False):
        self.shape, self.dtype = torch.Size(shape), torch.float32
        self.device, self.requires_grad = torch.device("cuda", 0), requires_grad


def _agsa_args(make, b=2, n=5, h=2, dk=8):
    return [make(b, n, h * dk) for _ in range(3)] + [
        make(*s) for s in ((dk, dk), (dk,)) * 4] + [h]


def test_agsa_wrapper_raises_off_cpu_and_cuda():
    """The AGSA wrapper raises for a tensor on neither the CPU nor a CUDA
    device, with and without grad, without counting a launch."""
    before = agsa_attn.agsa_attention_fused.launches
    args = _agsa_args(lambda *s: torch.zeros(*s, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        agsa_attn.agsa_attention_fused(*args)
    args[3].requires_grad_()
    with pytest.raises(ValueError, match="no kernel"):
        agsa_attn.agsa_attention_fused(*args)
    assert agsa_attn.agsa_attention_fused.launches == before


def test_agsa_wrapper_refuses_a_cuda_call_that_needs_a_gradient(monkeypatch):
    """A CUDA call with grad enabled and an input that requires grad goes to
    the autograd Function (whose bodies launch the two kernels), never to
    the plain version; such a call with N 65 raises for the kernels' limits
    before any launch, as does the backward wrapper; a CPU call that needs
    a gradient takes the Function's plain bodies (equal to autograd through
    agsa_attention_plain) and counts no launch."""
    fused, bwd = agsa_attn.agsa_attention_fused, agsa_attn.agsa_attention_bwd_fused
    before = fused.launches, bwd.launches
    applied = []

    class Spy:
        @staticmethod
        def apply(*a):
            applied.append(a)
            return "through the Function"

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached the plain version")

    with monkeypatch.context() as m:
        m.setattr(agsa_attn, "_AGSAAttention", Spy)
        m.setattr(agsa_attn, "agsa_attention_plain", refuse)
        m.setattr(agsa_attn, "agsa_attention_bwd_plain", refuse)
        grad_args = _agsa_args(lambda *s: _CudaStandIn(*s))
        grad_args[4] = _CudaStandIn(8, requires_grad=True)
        assert fused(*grad_args) == "through the Function"
        assert len(applied) == 1 and applied[0][-1] == 2
        big = _agsa_args(lambda *s: _CudaStandIn(*s), n=65)
        big[0] = _CudaStandIn(2, 65, 16, requires_grad=True)
        with pytest.raises(ValueError, match="limits"):
            fused(*big)
        with pytest.raises(ValueError, match="limits"):
            agsa_attn._guard("agsa_attention_bwd_fused", *big[:3], big[3:11], 2, big[0])
        with torch.no_grad(), pytest.raises(ValueError, match="limits"):
            fused(*big)
        assert len(applied) == 1
    g = torch.Generator().manual_seed(5)
    cpu = _agsa_args(lambda *s: torch.randn(*s, generator=g))
    cpu[0].requires_grad_()
    cpu[5].requires_grad_()
    out = fused(*cpu)
    assert out.grad_fn is not None and "AGSAAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out.sum(), [cpu[0], cpu[5]])
    want = torch.autograd.grad(agsa_attn.agsa_attention_plain(*cpu).sum(), [cpu[0], cpu[5]])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert (fused.launches, bwd.launches) == before


@pytest.mark.parametrize("drop,training,d_k,n,route", [
    (0.0, False, 32, 36, True),    # CAMERA's evaluation
    (0.0, True, 32, 36, True),     # drop 0 in training, as itrx routes it
    (0.1, False, 32, 32, True),    # dropout is the identity in eval
    (0.1, True, 32, 36, False),    # the attention dropout in effect
    (0.0, False, 12, 36, False),   # d_k % 8 != 0
    (0.0, False, 136, 36, False),  # d_k > 128
    (0.0, False, 32, 65, True),    # N > 64: itrx routes it; the wrapper raises
])
def test_agsa_route_predicate(drop, training, d_k, n, route):
    """GatedQueryAttLayer sends its attention to the kernel's wrapper exactly
    where `itrx` sends it to its Pallas kernel (no dropout in effect, d_k % 8
    == 0 and d_k <= 128), whatever the dtype and N: the route never reads N."""
    assert agsa.kernel_route(drop, training, d_k) is route


class _ToCuda(torch.nn.Module):
    """Stands in for a projection whose output lies on a CUDA device."""

    def forward(self, x):
        return _CudaStandIn(*x.shape)


def test_agsa_layer_on_cuda_beyond_the_kernels_n_raises():
    """A CUDA GatedQueryAttLayer call with N 65 (routed as itrx routes it)
    reaches the wrapper, which raises for the kernel's limits rather than
    computing the plain chain; nothing is launched."""
    before = agsa_attn.agsa_attention_fused.launches
    layer = agsa.GatedQueryAttLayer(16, 2, generator=torch.Generator().manual_seed(0)).eval()
    layer.linears = torch.nn.ModuleList(_ToCuda() for _ in range(3))
    with torch.no_grad(), pytest.raises(ValueError, match="limits"):
        layer(torch.zeros(2, 65, 16))
    assert agsa_attn.agsa_attention_fused.launches == before


def test_camera_evaluation_reaches_the_agsa_wrapper_in_both_towers(monkeypatch, tmp_path):
    """CAMERA's eval-mode embed reaches agsa_attention_fused once in each
    tower, without grad, and no grid kernel; fused_eval_active is False on
    every device; off the kernel route GatedQueryAttLayer takes its plain
    chain, which agrees with the wrapper's plain version."""
    calls = []

    def counting(*a):
        calls.append(torch.is_grad_enabled())
        return agsa_attn.agsa_attention_fused(*a)

    def refuse(*a, **k):
        raise AssertionError("an evaluation reached a grid kernel wrapper")

    monkeypatch.setattr(agsa, "agsa_attention_fused", counting)
    for name in ("xattn_t2i_fused", "xattn_i2t_fused"):
        monkeypatch.setattr(methods, name, refuse)
    bert = tmp_path / "bert_config.json"
    bert.write_text('{"vocab_size": 20, "hidden_size": 16, "num_hidden_layers": 1, '
                    '"num_attention_heads": 2, "intermediate_size": 32, '
                    '"max_position_embeddings": 16, "type_vocab_size": 2}')
    cfg = dict(_cfg(), name="CAMERA", img_dim=12, embed_size=32, head=4, smry_k=3,
               bert_config_file=str(bert))
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for dev in ("cpu", "cuda"):
        assert not model.fused_eval_active(torch.device(dev), train=False)
    g = torch.Generator().manual_seed(6)
    ids = torch.randint(1, 20, (3, 6), generator=g)
    corner = torch.rand(3, 5, 2, generator=g) * 50
    batch = {"images": torch.randn(3, 5, 12, generator=g), "cap_ids": ids,
             "cap_mask": torch.ones(3, 6), "type_ids": torch.zeros_like(ids),
             "boxes": torch.cat([corner, corner + 10], dim=-1),
             "imgs_wh": torch.full((3, 2), 100.0)}
    layer = model.img_enc.agsa.att_layers[0]
    x = torch.randn(3, 5, 32, generator=g)
    with torch.no_grad():
        e = model.embed(batch)
        assert calls == [False, False] and sorted(e) == ["cap", "img"]
        assert engine.cal_sims(model, e["img"], e["cap"], verbose=False).shape == (3, 3)
        want = layer(x)
        # the same weights, with the shape taken for one outside the limits
        monkeypatch.setattr(agsa, "kernel_route", lambda drop, training, d_k: False)
        plain = layer(x)
    assert calls == [False, False, False]
    torch.testing.assert_close(plain, want, rtol=1e-5, atol=1e-6)


def test_use_fused_eval_off_sends_scan_evaluation_to_the_plain_grid():
    """`use_fused_eval=False` reaches SCAN through get_model and keeps CUDA
    evaluation off the kernels, in both directions, as itrx's SCAN does."""
    for direction in ("t2i", "i2t"):
        assert _scan(cross_attn=direction, agg_func="Mean").use_fused_eval
        off = _scan(cross_attn=direction, agg_func="Mean", use_fused_eval=False)
        assert off.use_fused_eval is False
        assert not off.fused_eval_active(torch.device("cuda", 0))
        assert not off.fused_eval_active("cuda", train=False)


class _SentenceModel:
    """A sentence-level model for the engine's tiled grid: counts its
    `similarity` calls, each one image tile x one caption tile."""

    def __init__(self):
        self.calls = []

    def fused_eval_active(self, device, train=False):
        return False

    def similarity(self, img, cap, cap_mask, train=False):
        self.calls.append((img.shape[0], cap.shape[0]))
        return img @ cap.t()


def test_eval_tile_keys_reach_the_tiled_grid():
    """A config's eval_img_tile / eval_cap_tile set the tiles of
    `_cal_sims_tiled` through `_grid` (as itrx's cal_sims reads them), and
    the grid equals the one of the default tiles."""
    g = torch.Generator().manual_seed(3)
    # small integers: every sum exact, whatever order a tile's product takes
    enc = {k: torch.randint(-4, 5, (14, 6), generator=g).float() for k in ("img", "cap")}
    default = _SentenceModel()
    want = engine._grid(default, enc, {}, 1)
    assert default.calls == [(14, 14)]
    tiled = _SentenceModel()
    got = engine._grid(tiled, enc, {"eval_img_tile": 4, "eval_cap_tile": 5}, 1)
    assert len(tiled.calls) == 4 * 3
    assert max(tiled.calls) == (4, 5) and min(tiled.calls) == (2, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
