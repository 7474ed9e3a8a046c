"""The port's own copies of the JAX package's config and data modules
(itrx_torch.configs, itrx_torch.data) against the originals, on the CPU:
the same configs from the same command lines, the same batches from the
same split, and the shipped vocabularies read from the repo's itrx/vocab/."""

import os

import numpy as np
import pytest

from itrx import configs as jconfigs
from itrx.data import precomp as jprecomp
from itrx.data import synthetic as jsynthetic
from itrx_torch import configs
from itrx_torch.data import precomp, synthetic


@pytest.mark.parametrize("argv", [
    ["with", "SCAN", "seed=3"],
    ["with", "SCAN", "data_name=coco_precomp", "bi_gru=True", "cross_attn=i2t",
     "agg_func=Mean", "lambda_softmax=4", "seed=1"],
    ["SGRAF", "batch_size=64", "module_name=SGR", "seed=0"],
    ["with", "SAEM", "max_words=40", "seed=2"],
    ["with", "VSE++", "mesh_shape={'dp': 2}", "seed=5"],
])
def test_parse_cli_matches_jax(argv):
    got = configs.parse_cli(argv, make_dirs=False)
    assert got == jconfigs.parse_cli(argv, make_dirs=False)
    assert configs.load_hyperparams == jconfigs.load_hyperparams


def test_parse_cli_refuses_what_jax_refuses():
    for mod in (configs, jconfigs):
        with pytest.raises(ValueError, match="Unknown named config"):
            mod.parse_cli(["with", "NOPE"], make_dirs=False)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """One synthetic split written by each package's generator."""
    root = tmp_path_factory.mktemp("torch_data")
    kw = dict(n_images=40, img_dim=16, seed=7, n_concepts_range=(1, 9))
    d = synthetic.generate(str(root / "synthetic"), **kw)
    jd = jsynthetic.generate(str(root / "jax" / "synthetic"), **kw)
    cfg = configs.parse_cli(
        ["with", "SCAN", f"data_path={root}", "data_name=synthetic",
         f"vocab_path={d}/vocab", "seed=0"], make_dirs=False)
    return cfg, d, jd


def test_generate_matches_jax(split):
    _, d, jd = split
    for name in sorted(os.listdir(jd)):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(f"{d}/{name}"), np.load(f"{jd}/{name}"))
        else:
            with open(f"{d}/{name}") as a, open(f"{jd}/{name}") as b:
                assert a.read() == b.read(), name


def _assert_same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_loaders_give_the_jax_batches(split):
    cfg, _, _ = split
    train, val, n = precomp.get_loaders(cfg)
    jtrain, jval, jn = jprecomp.get_loaders(cfg)
    assert n == jn and len(train) == len(jtrain) and len(val) == len(jval)
    for got, want in zip(train.train_batches(16, seed=3, epoch=1),
                         jtrain.train_batches(16, seed=3, epoch=1)):
        _assert_same_batch(got, want)
    test, tn = precomp.get_test_loader("test", cfg)
    jtest, jtn = jprecomp.get_test_loader("test", cfg)
    assert tn == jtn and test.im_div == jtest.im_div == 5
    batches = list(zip(test.eval_batches(24), jtest.eval_batches(24)))
    assert batches[-1][0]["n_valid"] < 24  # the zero-padded last batch
    for got, want in batches:
        _assert_same_batch(got, want)


def test_shipped_vocab_is_read_from_the_repo(split, tmp_path):
    """With no vocabulary under vocab_path, f30k_precomp falls back to the
    vocabulary shipped in itrx/vocab/, in both packages."""
    cfg, d, _ = split
    os.symlink(d, tmp_path / "f30k_precomp")
    fcfg = dict(cfg, data_path=str(tmp_path), data_name="f30k_precomp",
                vocab_path=str(tmp_path / "no_vocab_here"))
    got, n = precomp.get_test_loader("test", fcfg)
    want, jn = jprecomp.get_test_loader("test", fcfg)
    assert os.path.samefile(os.path.dirname(precomp.SHIPPED_VOCAB_DIR),
                            os.path.dirname(os.path.dirname(jprecomp.__file__)))
    assert n == jn > 1000
    np.testing.assert_array_equal(got.cap_ids, want.cap_ids)
    assert not os.path.exists(tmp_path / "no_vocab_here")


def test_raw_image_datasets_name_their_roadmap_item(split):
    cfg, _, _ = split
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        precomp.get_test_loader("test", dict(cfg, data_name="f30k"))
