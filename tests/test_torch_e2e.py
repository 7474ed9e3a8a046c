"""The port's training and offline-evaluation slices end to end on the CPU,
on tiny synthetic splits: fit raises recall, resume restores the run,
prefetch relays producer errors, and port checkpoints convert unchanged into
the JAX package, whose evalrank_single and evalrank_ensemble (with and
without fold5) then rank exactly as the port's."""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itrx.configs import parse_cli
from itrx.data import synthetic
from itrx.eval import engine as jengine
from itrx.eval.engine import evalrank_ensemble as jevalrank_ensemble
from itrx.eval.engine import evalrank_single as jevalrank_single
from itrx.utils.ref_convert import convert_reference_checkpoint
from itrx_torch.data import vocab as vocab_mod
from itrx_torch.eval import engine
from itrx_torch.eval.engine import evalrank_ensemble, evalrank_single
from itrx_torch.models import get_model, methods
from itrx_torch.train.loop import fit, prefetch
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

# 8 dev images x 5 captions; chance rsum is about 320 (t2i r1/r5/r10 =
# 12.5/62.5/100, i2t about 12.5/52/78)
CHANCE_RSUM = 320.0


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_e2e")
    d = synthetic.generate(str(root / "synthetic"), n_images=24, img_dim=48)
    return str(root), d


def _args(synth, save, **kw):
    root, d = synth
    args = dict(data_path=root, data_name="synthetic", vocab_path=f"{d}/vocab",
                vocab_type="json", img_dim=48, embed_size=32, word_dim=16,
                batch_size=24, num_epochs=10, val_step=0, log_step=5,
                learning_rate=0.01, save_path=f"{root}/{save}",
                max_violation=False, seed=3)
    args.update(kw)
    return ["with", "SCAN"] + [f"{k}={v}" for k, v in args.items()]


@pytest.fixture(scope="module")
def trained(synth):
    cfg = parse_cli(_args(synth, "runs"))
    state, best_rsum = fit(cfg, device="cpu")
    return cfg, state, best_rsum


def test_scan_fit_raises_recall_and_checkpoints(trained):
    cfg, state, best_rsum = trained
    # 24 train images x 5 captions / batch 24 = 5 updates per epoch
    assert state.step == 10 * 5
    assert best_rsum > CHANCE_RSUM + 100, best_rsum
    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    ck = load_checkpoint(best)
    assert set(ck) == {"epoch", "model", "best_rsum", "best_r1", "opt", "Eiters", "_config"}
    assert ck["best_rsum"] == pytest.approx(best_rsum)
    assert [sorted(sd) for sd in ck["model"]] == [
        ["fc.bias", "fc.weight"],
        ["embed.weight", "rnn.bias_hh_l0", "rnn.bias_ih_l0", "rnn.weight_hh_l0",
         "rnn.weight_ih_l0"],
    ]
    for e in range(10):
        assert os.path.exists(os.path.join(cfg["save_dir"], f"epo{e}_checkpoint.pth.tar"))
    res = evalrank_single(best, split="dev", device="cpu")
    assert res["rsum"] == pytest.approx(ck["best_rsum"], abs=1e-9)


def test_resume_restores_state(synth, trained):
    cfg, _, _ = trained
    ckpt_path = os.path.join(cfg["save_dir"], "epo1_checkpoint.pth.tar")
    ck = load_checkpoint(ckpt_path)
    assert ck["epoch"] == 1 and ck["Eiters"] == 10

    # resuming into an epoch count the checkpoint already reached trains
    # nothing: the restored state is the checkpoint's
    cfg2 = parse_cli(_args(synth, "resumed", resume=ckpt_path, num_epochs=1))
    state, best = fit(cfg2, device="cpu")
    assert state.step == ck["Eiters"]
    assert best == ck["best_rsum"]
    opt = state.optimizer.state_dict()
    assert opt["param_groups"] == ck["opt"]["param_groups"]
    for i, s in ck["opt"]["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(opt["state"][i][k], v, rtol=0, atol=0)
    for name, sd in zip(("img_enc", "txt_enc"), ck["model"]):
        for k, v in getattr(state.model, name).state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)

    # and training on counts on from it (the saved epoch is run again, as in
    # the JAX package)
    cfg3 = parse_cli(_args(synth, "resumed2", resume=ckpt_path, num_epochs=3))
    state3, _ = fit(cfg3, device="cpu")
    assert state3.step == ck["Eiters"] + 2 * 5


def test_fit_passes_the_epoch_to_the_loss(synth, monkeypatch):
    """make_train_step and fit hand the epoch to model.loss, as itrx's step
    does (only SAEM's loss reads it): a spy loss sees epoch 0 for the first
    epoch's 5 updates and 1 for the second's."""
    seen = []
    loss = methods.SCAN.loss

    def spy(self, batch, train=True, epoch=0):
        seen.append(epoch)
        return loss(self, batch, train=train, epoch=epoch)

    monkeypatch.setattr(methods.SCAN, "loss", spy)
    state, _ = fit(parse_cli(_args(synth, "epochs", num_epochs=2)), device="cpu")
    assert state.step == 10 and seen == [0] * 5 + [1] * 5


def test_prefetch_propagates_producer_errors():
    def bad_iter():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("loader exploded")

    it = prefetch(bad_iter(), "cpu")
    first = next(it)
    assert isinstance(first["x"], torch.Tensor)
    with pytest.raises(RuntimeError, match="loader exploded"):
        next(it)


def test_port_checkpoint_converts_into_the_jax_package(trained, tmp_path):
    """convert_reference_checkpoint reads the port's model_best.pth.tar
    unchanged; the JAX evalrank_single on the result gives the port's ranks
    exactly and its rsum to fp32 rounding (the JAX package computes the
    stats in fp32, the port in float64)."""
    cfg, _, _ = trained
    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    out = convert_reference_checkpoint(best, out_path=str(tmp_path / "best.itrx"))
    want = jevalrank_single(out, split="dev")
    got = evalrank_single(best, split="dev", device="cpu")
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["rsum"] == pytest.approx(float(want["rsum"]), rel=1e-6)


STAT_KEYS = ("rsum", "i2t_ave_r", "i2t_r1", "i2t_r5", "i2t_r10", "i2t_medr",
             "i2t_meanr", "t2i_ave_r", "t2i_r1", "t2i_r5", "t2i_r10",
             "t2i_medr", "t2i_meanr")
I2T_AVG = dict(cross_attn="i2t", agg_func="Mean", lambda_softmax=4.0)


def _assert_same_recall(got, want):
    """Identical ranks; stats equal up to the JAX package's fp32 rounding
    (the port computes them in float64)."""
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for k in STAT_KEYS:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-6), k


def _random_checkpoint(cfg, seed, path):
    """A port `.pth.tar` with random weights from `seed`."""
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    save_checkpoint(create_train_state(model, cfg, 1), cfg, 0, 0.0, 0.0, path)
    return path


def test_evalrank_ensemble_matches_jax(synth, trained, tmp_path):
    """The trained t2i model with a random i-t AVG model: the port's
    evalrank_ensemble and the JAX one on the converted checkpoints rank
    identically, and the ensemble is neither member alone."""
    cfg, _, _ = trained
    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    icfg = parse_cli(_args(synth, "i2t", **I2T_AVG), make_dirs=False)
    icfg["vocab_size"] = cfg["vocab_size"]
    ck2 = _random_checkpoint(icfg, 5, str(tmp_path / "i2t.pth.tar"))
    j1 = convert_reference_checkpoint(best, out_path=str(tmp_path / "t2i.itrx"))
    j2 = convert_reference_checkpoint(ck2, out_path=str(tmp_path / "i2t.itrx"))
    want = jevalrank_ensemble(j1, j2, split="dev")
    got = evalrank_ensemble(best, ck2, split="dev", device="cpu")
    _assert_same_recall(got, want)
    assert got["data_name"] == want["data_name"] == "synthetic"
    assert (got["modal_path_1"], got["modal_path_2"]) == (best, ck2)
    alone = [evalrank_single(p, split="dev", device="cpu")["t2i_ranks"] for p in (best, ck2)]
    assert all(not np.array_equal(got["t2i_ranks"], r) for r in alone)


def _cheap_grid(img, cap, mask):
    """A stand-in for cal_sims in the fold5 tests (a real SCAN grid of 5000
    captions per fold is too slow here): a function of integers only, each
    image's and caption's strongest mean-pooled embedding coordinate and the
    caption's length, so the two packages' embeddings (which differ by
    ~1e-7) give bit-identical grids, with many exact ties."""
    img, cap, mask = (np.asarray(a, np.float64) for a in (img, cap, mask))
    ia = img.mean(axis=1).argmax(-1)
    ca = (cap * mask[..., None]).sum(axis=1).argmax(-1)
    length = mask.sum(axis=1)
    return ((ia[:, None] == ca[None, :]) + 0.125 * (length[None, :] % 5)
            + 2.0 ** -6 * ia[:, None]).astype(np.float32)


@pytest.fixture(scope="module")
def testall(tmp_path_factory):
    """A coco-testall-shaped split (5000 images, 25000 captions) at narrow
    widths, and a t2i and an i-t AVG checkpoint for it, each as a port
    `.pth.tar` and converted for the JAX package."""
    root = tmp_path_factory.mktemp("torch_fold5")
    synthetic.generate(str(root / "coco_precomp"), n_images=20000, img_dim=8,
                       splits=("testall",), seed=4, n_concepts_range=(1, 10))
    vocab_path = str(Path(__file__).resolve().parents[1] / "itrx" / "vocab")
    n_vocab = len(vocab_mod.deserialize_vocab(f"{vocab_path}/coco_precomp_vocab.json"))
    ckpts = {}
    for seed, (name, kw) in enumerate((("t2i", {}), ("i2t", I2T_AVG))):
        args = dict(data_path=str(root), data_name="coco_precomp", vocab_path=vocab_path,
                    vocab_type="json", img_dim=8, embed_size=8, word_dim=8,
                    batch_size=1000, seed=0, **kw)
        cfg = parse_cli(["with", "SCAN"] + [f"{k}={v}" for k, v in args.items()],
                        make_dirs=False)
        cfg["vocab_size"] = n_vocab
        port = _random_checkpoint(cfg, seed, str(root / f"{name}.pth.tar"))
        ckpts[name] = (port, convert_reference_checkpoint(port, str(root / f"{name}.itrx")))
    return ckpts


@pytest.fixture
def cheap_sims(monkeypatch):
    monkeypatch.setattr(engine, "cal_sims", lambda model, img, cap, mask, **kw:
                        torch.from_numpy(_cheap_grid(img, cap, mask)))
    monkeypatch.setattr(jengine, "cal_sims", lambda model, variables, img, cap, mask, **kw:
                        jnp.asarray(_cheap_grid(img, cap, mask)))


def _assert_same_fold5(got, want):
    assert got["data_name"] == want["data_name"] == "coco_precomp_5fold"
    for i in range(1, 6):
        _assert_same_recall(got[f"PART_{i}"], want[f"PART_{i}"])
    assert np.array(got["sum_result"]) == pytest.approx(np.array(want["sum_result"]), rel=1e-6)
    assert set(got["Mean_metrics"]) == set(want["Mean_metrics"])
    for k, v in want["Mean_metrics"].items():
        assert got["Mean_metrics"][k] == pytest.approx(float(v), rel=1e-6), k
        parts = [got[f"PART_{i}"][k] for i in range(1, 6)]
        assert got["Mean_metrics"][k] == pytest.approx(sum(parts) / 5, abs=1e-9), k


def test_evalrank_single_fold5_matches_jax(testall, cheap_sims):
    port, converted = testall["i2t"]
    want = jevalrank_single(converted, split="testall", fold5=True)
    got = evalrank_single(port, split="testall", fold5=True, device="cpu")
    _assert_same_fold5(got, want)
    assert len(got["PART_1"]["t2i_ranks"]) == 5000 and len(got["PART_1"]["i2t_ranks"]) == 1000


def test_evalrank_ensemble_fold5_matches_jax(testall, cheap_sims):
    (p1, j1), (p2, j2) = testall["t2i"], testall["i2t"]
    want = jevalrank_ensemble(j1, j2, split="testall", fold5=True)
    got = evalrank_ensemble(p1, p2, split="testall", fold5=True, device="cpu")
    _assert_same_fold5(got, want)


@pytest.mark.parametrize("override,item", [
    ("train_bf16=True", "item 7"),
    ("mesh_shape={'dp': 2}", "item 13"),
    ("multihost=True", "item 13"),
])
def test_fit_names_the_roadmap_item_of_what_is_not_ported(synth, override, item):
    cfg = parse_cli(_args(synth, "refused") + [override], make_dirs=False)
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        fit(cfg, device="cpu")
