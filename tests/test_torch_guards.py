"""Guards of the port: it imports neither JAX nor the JAX package, its
entry points run on the card unless asked for the CPU, its kernel wrappers
never fall back to plain code for a non-CPU tensor, the forward-only xattn
kernels are kept out of training, gradients reach every trained parameter,
and its kernel sources and build directory are where the wrappers and
.gitignore say."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from itrx_torch.eval import engine
from itrx_torch.models import get_model, methods, sgraf
from itrx_torch.ops import kernels
from itrx_torch.ops.kernels import gru, sgraf_eval, xattn
from itrx_torch.train import loop

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


@pytest.mark.parametrize("module", [gru, xattn, sgraf_eval])
def test_kernel_sources_exist(module):
    src = kernels.CSRC / module.SOURCE
    assert src.exists(), src
    assert "extern \"C\"" in src.read_text()


def test_gru_bwd_source_exists():
    src = kernels.CSRC / gru.BWD_SOURCE
    assert src.exists(), src
    assert "extern \"C\"" in src.read_text()


def test_xattn_i2t_source_exists():
    src = kernels.CSRC / xattn.I2T_SOURCE
    assert "int itrx_xattn_i2t(" in src.read_text()
    assert '#include "xattn_product.cuh"' in src.read_text()


def test_kernel_build_tracks_the_shared_header(tmp_path, monkeypatch):
    """The library name hashes the shared headers too, so an edited header
    rebuilds both xattn kernels."""
    for name in ("xattn.cu", "xattn_i2t.cu", "xattn_product.cuh"):
        (tmp_path / name).write_text((kernels.CSRC / name).read_text())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = [kernels.library_path(n) for n in ("xattn", "xattn_i2t")]
    (tmp_path / "xattn_product.cuh").write_text("// edited\n")
    after = [kernels.library_path(n) for n in ("xattn", "xattn_i2t")]
    assert all(a != b for a, b in zip(before, after))


def _saf_args(dev="cpu", ni=2, nc=3, l=5, d=8, s=4, **kw):
    g = torch.Generator().manual_seed(0)
    t = lambda *sh: torch.randn(*sh, generator=g).to(dev)  # noqa: E731
    args = dict(cap=t(nc, l, d), mask=torch.ones(nc, l, device=dev), img=t(ni, 36, d),
                w=t(s, d), b=t(s), gloc=t(nc, d), imgglo=t(ni, d), gw=t(s, d), gb=t(s),
                awf=t(s), abf=t(1), ew=t(1, s), eb=t(1))
    args.update(kw)
    return args


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
    with pytest.raises(RuntimeError, match="forward-only.*item 8c"):
        sgraf_eval.sgraf_eval_saf_fused(**args)
    with torch.no_grad():
        assert sgraf_eval.sgraf_eval_saf_fused(**args).shape == (3, 2)
    assert sgraf_eval.sgraf_eval_saf_fused.launches == before


def _sgraf(**kw):
    cfg = dict(_cfg(), name="SGRAF", sim_dim=8, module_name="SAF", cap_chunk=2)
    cfg.update(kw)
    return get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def test_sgraf_sends_only_evaluation_to_the_kernel(monkeypatch):
    """Evaluation on the card goes to the kernel wrapper (the BatchNorm
    folded into the gate); on the CPU to the plain chain; training raises,
    naming the item that ports it."""
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
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8c"):
        model.similarity(img, cap, mask, train=True)
    assert calls == [13]


def test_sgraf_sgr_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8b"):
        _sgraf(module_name="SGR")


def test_sgraf_saf_training_names_its_roadmap_item():
    model = _sgraf()
    nodes, nmask = torch.zeros(2, 3, 8), torch.ones(2, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8c"):
        model.sim_enc.SAF_module(nodes, nmask, train=True)
    model.train()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8c"):
        model.sim_enc(torch.zeros(2, 36, 16), torch.zeros(3, 4, 16), torch.ones(3, 4))


def test_check_supported_refuses_sgraf_training():
    with pytest.raises(NotImplementedError, match="only SCAN"):
        loop.check_supported(dict(_cfg(), name="SGRAF", module_name="SAF"))


def test_sgraf_eval_saf_source_is_built_and_hashed(tmp_path, monkeypatch):
    """The SAF kernel's library name hashes its source and the shared A
    product header it includes."""
    src = kernels.CSRC / sgraf_eval.SOURCE
    assert "int itrx_sgraf_eval_saf(" in src.read_text()
    assert '#include "xattn_product.cuh"' in src.read_text()
    for name in (sgraf_eval.SOURCE, "xattn_product.cuh"):
        (tmp_path / name).write_text((kernels.CSRC / name).read_text())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    first = kernels.library_path("sgraf_eval_saf")
    (tmp_path / "xattn_product.cuh").write_text("// edited\n")
    second = kernels.library_path("sgraf_eval_saf")
    (tmp_path / sgraf_eval.SOURCE).write_text("// edited\n")
    assert len({first, second, kernels.library_path("sgraf_eval_saf")}) == 3
