"""The port's training slice end to end on the CPU, on a tiny synthetic
split: fit raises recall, resume restores the run, prefetch relays producer
errors, and a port checkpoint converts unchanged into the JAX package,
whose evalrank_single then ranks exactly as the port's."""

import os

import numpy as np
import pytest
import torch

from itrx.configs import parse_cli
from itrx.data import synthetic
from itrx.eval.engine import evalrank_single as jevalrank_single
from itrx.utils.ref_convert import convert_reference_checkpoint
from itrx_torch.eval.engine import evalrank_single
from itrx_torch.train.loop import fit, prefetch
from itrx_torch.utils.checkpoint import load_checkpoint

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
    res = evalrank_single(best, split="dev")
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
    got = evalrank_single(best, split="dev")
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["rsum"] == pytest.approx(float(want["rsum"]), rel=1e-6)


def test_evalrank_single_refuses_fold5(trained):
    cfg, _, _ = trained
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 4"):
        evalrank_single(os.path.join(cfg["save_dir"], "model_best.pth.tar"), fold5=True)


@pytest.mark.parametrize("override,item", [
    ("train_bf16=True", "item 7"),
    ("mesh_shape={'dp': 2}", "item 13"),
    ("multihost=True", "item 13"),
])
def test_fit_names_the_roadmap_item_of_what_is_not_ported(synth, override, item):
    cfg = parse_cli(_args(synth, "refused") + [override], make_dirs=False)
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        fit(cfg, device="cpu")
