"""The port's CAMERA evaluation slice vs the JAX package on the CPU, at the
small widths of tests/test_torch_camera.py, on a tiny synthetic f30k-named
split (16 test images x 80 captions, boxes and image sizes, a tiny BERT
vocabulary) with one thin box (height ~1e-3 px at y = 150, which bf16
collapses to 0): encode_data -> cal_sims (the 3-D image stack against 2-D
captions) -> cal_recall through evaluate_split, fp32 and bf16; the bf16
encode with the box geometry kept fp32; the engine's tiling of the 3-D
stack; and a port CAMERA checkpoint into the JAX evalrank_single."""

import numpy as np
import pytest
import torch

from itrx.configs import parse_cli
from itrx.eval import engine as jengine
from itrx.eval.engine import evalrank_single as jevalrank_single
from itrx.models import get_model as jget_model
from itrx.ops.pallas import dispatch_counts, force_interpret, reset_dispatch
from itrx.utils.ref_convert import convert_reference_checkpoint
from itrx_torch.data import precomp, synthetic
from itrx_torch.eval import engine
from itrx_torch.eval.engine import evalrank_single
from itrx_torch.models import get_model
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.test_torch_camera import (FP32_ATOL, HEADS, IMG, R, SMRY_K, E, bert_config_file,
                                     camera_cfg, jax_variables, port_model)

torch.set_num_threads(1)

MAX_WORDS = 12
# bf16 encode: both packages run the towers in bf16, `itrx` its Pallas
# kernel in interpret mode, the port the kernel's plain version with the same
# rounding points; summation order moves bf16 roundings apart through BERT
# and the towers (the embeddings are unit-norm)
BF16_ATOL = 3e-2
# rsum of the bf16 slice against `itrx`'s bf16 slice: the two grids rank a few
# near-tied pairs apart (as the SGRAF and VSRN slices)
BF16_RSUM = 30.0
THIN_BOX = (10.0, 150.0, 90.0, 150.001)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """The split, the config and CAMERA in both packages with the same
    weights (BatchNorms perturbed)."""
    root = tmp_path_factory.mktemp("torch_camera")
    d = synthetic.generate(str(root / "f30k_precomp"), n_images=64, img_dim=IMG, n_regions=R,
                           n_concepts_range=(1, 4))
    boxes = np.load(f"{d}/test_boxes.npy")
    boxes[0, 0] = THIN_BOX
    np.save(f"{d}/test_boxes.npy", boxes)
    cfg = dict(camera_cfg(bert_config_file(root / "bert_config.json")),
               data_path=str(root), data_name="f30k_precomp", text_encoder="bert",
               vocab_file=synthetic.write_tiny_bert_vocab(str(root / "vocab.txt")),
               max_words=MAX_WORDS, use_bbox=True, batch_size=24)
    ds = precomp.PrecompDataset(d, "test", cfg)
    cfg["vocab_size"] = ds.vocab_size
    batch = ds.gather(np.arange(6))
    assert batch["boxes"].dtype == np.float32 and np.float32(150.001) != np.float32(150.0)
    variables = jax_variables(cfg, batch, seed=3)
    return cfg, ds, jget_model(cfg), variables, port_model(cfg, variables)


def _assert_same_ranks(got, want):
    for k in ("i2t_ranks", "t2i_ranks"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["rsum"] == pytest.approx(float(want["rsum"]), rel=1e-6)


def test_camera_slice_matches_jax(slice_setup):
    """encode_data -> cal_sims -> cal_recall through evaluate_split in both
    packages, fp32: the (Ni, smry_k, D) and (Nc, D) stacks and the grid at
    1e-5, and identical ranks."""
    cfg, ds, jmodel, variables, model = slice_setup
    want = jengine.evaluate_split(jmodel, variables, ds, cfg)
    got = engine.evaluate_split(model, ds, cfg, device="cpu")
    _assert_same_ranks(got, want)
    jenc = jengine.encode_data(jmodel, variables, ds, cfg["batch_size"])
    enc = engine.encode_data(model, ds, cfg["batch_size"], device="cpu")
    assert sorted(enc) == ["cap", "img"]
    assert enc["img"].shape == (len(ds), SMRY_K, E) and enc["cap"].shape == (len(ds), E)
    for k in ("img", "cap"):
        np.testing.assert_allclose(enc[k].numpy(), np.asarray(jenc[k]), atol=FP32_ATOL)
    jsims = jengine.cal_sims(jmodel, variables, jenc["img"][:: ds.im_div], jenc["cap"],
                             verbose=False)
    sims = engine.cal_sims(model, enc["img"][:: ds.im_div], enc["cap"], verbose=False)
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=FP32_ATOL)


def test_camera_bf16_encode_keeps_boxes_fp32_and_matches_itrx(slice_setup):
    """encode_data with encode_dtype bf16: the model receives bf16 regions
    but fp32 boxes and image sizes (a spy on the image tower's inputs), the
    split's thin box included; the embeddings are finite and within a bf16
    tolerance of `itrx`'s bf16 encode with its Pallas kernel (interpret
    mode); the running statistics stay fp32 and unchanged; and the bf16
    slice through evaluate_split ranks within BF16_RSUM of `itrx`'s."""
    cfg, ds, jmodel, variables, model = slice_setup
    before = {k: v.clone() for k, v in model.state_dict().items()}
    seen = []
    hook = model.img_enc.register_forward_pre_hook(
        lambda _, args: seen.append(tuple(a.dtype for a in args)))
    try:
        enc = engine.encode_data(model, ds, cfg["batch_size"], device="cpu",
                                 compute_dtype=torch.bfloat16, encode_dtype=torch.bfloat16)
    finally:
        hook.remove()
    assert seen and all(s == (torch.bfloat16, torch.float32, torch.float32) for s in seen)
    reset_dispatch()
    with force_interpret():
        jenc = jengine.encode_data(jmodel, variables, ds, cfg["batch_size"],
                                   compute_dtype="bfloat16", encode_dtype="bfloat16")
    assert dispatch_counts().get("agsa_fused", 0) == 2  # both towers, traced once
    for k in ("img", "cap"):
        assert enc[k].dtype == torch.bfloat16 and torch.isfinite(enc[k].float()).all()
        np.testing.assert_allclose(enc[k].float().numpy(), np.asarray(jenc[k], np.float32),
                                   atol=BF16_ATOL, err_msg=k)
    for k, v in model.state_dict().items():
        assert v.dtype == before[k].dtype
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    bcfg = dict(cfg, encode_bf16=True, eval_bf16=True)
    got = engine.evaluate_split(model, ds, bcfg, device="cpu")
    with force_interpret():
        want = jengine.evaluate_split(jmodel, variables, ds, bcfg)
    assert abs(got["rsum"] - float(want["rsum"])) <= BF16_RSUM, (got["rsum"], want["rsum"])


def test_cal_sims_3d_image_stack_tiles_match_one_product(slice_setup, monkeypatch):
    """CAMERA's (Ni, smry_k, D) image stack against (Nc, D) captions goes
    through the engine's tiled grid, tiled on its first axis: with tiles of 4
    images x 8 captions, the same grid as one similarity call, bit for bit,
    and bf16 stacks give an fp32 grid."""
    _, _, _, _, model = slice_setup
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.standard_normal((11, SMRY_K, E)).astype(np.float32))
    cap = torch.from_numpy(rng.standard_normal((21, E)).astype(np.float32))
    want = model.similarity(img, cap)
    monkeypatch.setattr(engine, "IMG_TILE", 4)
    monkeypatch.setattr(engine, "CAP_TILE", 8)
    got = engine.cal_sims(model, img, cap, None, verbose=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    half = engine.cal_sims(model, img, cap, compute_dtype=torch.bfloat16, verbose=False)
    assert half.dtype == torch.float32
    torch.testing.assert_close(half, model.similarity(img.bfloat16(), cap.bfloat16()),
                               rtol=0, atol=0)


def test_camera_checkpoint_converts_into_the_jax_package(slice_setup, tmp_path):
    """A port CAMERA checkpoint ([img_enc, txt_enc], BERT in the text part)
    goes through convert_reference_checkpoint into the JAX evalrank_single
    with identical ranks, and the port's evalrank_single reads it back."""
    base, _, _, _, model = slice_setup
    cfg = parse_cli(["with", "CAMERA", f"data_path={base['data_path']}",
                     "data_name=f30k_precomp", f"vocab_file={base['vocab_file']}",
                     f"bert_config_file={base['bert_config_file']}",
                     f"init_checkpoint={tmp_path / 'no_bert.bin'}", f"img_dim={IMG}",
                     f"embed_size={E}", f"head={HEADS}", f"smry_k={SMRY_K}",
                     f"max_words={MAX_WORDS}", "batch_size=24"], make_dirs=False)
    cfg["vocab_size"] = base["vocab_size"]
    port = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    port.load_state_dict(model.state_dict())
    path = str(tmp_path / "camera.pth.tar")
    save_checkpoint(create_train_state(port, cfg, 1), cfg, 0, 0.0, 0.0, path)
    assert [len(sd) for sd in load_checkpoint(path)["model"]] == [
        len(port.img_enc.state_dict()), len(port.txt_enc.state_dict())]
    out = convert_reference_checkpoint(path, out_path=str(tmp_path / "camera.itrx"))
    want = jevalrank_single(out, split="test")
    got = evalrank_single(path, split="test", device="cpu")
    _assert_same_ranks(got, want)
