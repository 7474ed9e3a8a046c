"""train_bf16 on the CPU: the port's mixed-precision train step
(train/loop.py::cast_loss, make_train_step(..., compute_dtype=bf16)) against
`itrx`'s make_train_step(model, tx, compute_dtype="bfloat16") for the six
methods at small widths, dropouts 0, from converted weights.

Two correct bf16 steps do not agree to fp32 precision: each framework rounds
at its own points (XLA fuses elementwise chains and rounds once; PyTorch
rounds after each op), and the rounding moves softmaxes, hinge terms and
ReLUs.  So each step is held to `itrx`'s within the distance bf16 itself
puts between `itrx`'s bf16 step and the fp32 step (`NOISE_K`, below), and
the loss within `LOSS_REL`.  Master parameters, Adam's state and the
BatchNorm statistics stay fp32.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from itrx.models import get_model as jget_model
from itrx.train import loop as jloop
from itrx.train import state as jstate
from itrx_torch.models import get_model
from itrx_torch.train.loop import cast_loss, fit, make_train_step
from itrx_torch.train.state import create_train_state
from itrx_torch.utils.checkpoint import load_checkpoint
from itrx_torch.utils.convert import from_itrx_variables
from tests import test_torch_camera as tcam
from tests import test_torch_saem as tsaem
from tests import test_torch_sgraf as tsgraf
from tests import test_torch_train as tscan
from tests import test_torch_vsepp as tvsepp
from tests import test_torch_vsrn as tvsrn
from tests.test_torch_camera_train import ZERO_GRADS as CAMERA_ZERO
from tests.test_torch_saem import ZERO_GRADS as SAEM_ZERO
from tests.test_torch_sgraf_train import SGR_ZERO_GRADS, ZERO_GRADS as SAF_ZERO
from tests.test_torch_vsrn_train import ZERO_GRADS as VSRN_ZERO

torch.set_num_threads(1)

BF16 = torch.bfloat16
METHODS = ("scan", "sgraf_saf", "sgraf_sgr", "vsrn", "camera", "vsepp", "saem")
LOSS_REL = 1e-2
NOISE_K = 2.0
# gradients that bf16's rounding alone sets (zero in exact arithmetic: a bias
# before a train-mode BatchNorm, a key bias before a softmax) are held to
# this share of the model's largest gradient norm instead
NOISE_FLOOR = 2.0 ** -8
# the port's bf16 step stands at least this share of `itrx`'s bf16 distance
# from the fp32 step (a step that ran in fp32 stands at 0)
BF16_APART = 0.25
RMS_LR = 1.0
# the gradients that are zero in exact arithmetic, as the fp32 tests name
# them (each method's ZERO_GRADS): bf16's rounding alone sets them
EXACT_ZERO = {"sgraf_saf": SAF_ZERO, "sgraf_sgr": SGR_ZERO_GRADS, "vsrn": VSRN_ZERO,
              "camera": CAMERA_ZERO}


def _exact_zero(name: str, k: str) -> bool:
    return k in EXACT_ZERO.get(name, ()) or (name == "saem" and k.endswith(SAEM_ZERO))


def _cfg(name: str, tmp) -> dict:
    """The method's tiny config (the widths of its fp32 tests), dropouts 0,
    steps_per_epoch 2 with lr_update 1 (the third update at lr / 10)."""
    if name == "scan":
        cfg = tscan._cfg(True)
    elif name == "sgraf_saf":
        cfg = tsgraf._cfg()
    elif name == "sgraf_sgr":
        cfg = tsgraf._cfg(module_name="SGR", sgr_step=2)
    elif name == "vsrn":
        cfg = tvsrn._cfg()
    elif name == "camera":
        cfg = tcam.camera_cfg(tcam.bert_config_file(tmp / "bert.json"), smry_k=3)
    elif name == "vsepp":
        cfg = tvsepp._cfg()
    else:
        (tmp / "bert.json").write_text(json.dumps(tsaem.BERT))
        (tmp / "trans.json").write_text(json.dumps(tsaem.TRANS))
        cfg = tsaem._cfg((str(tmp / "bert.json"), str(tmp / "trans.json")), txt_stru="rnn")
    return dict(cfg, learning_rate=1e-3, lr_update=1, grad_clip=2.0, seed=0)


def _batch_fn(name: str):
    return {"scan": tscan._batch, "sgraf_saf": tsgraf._batch, "sgraf_sgr": tsgraf._batch,
            "vsrn": tvsrn._batch, "camera": tcam.camera_batch, "vsepp": tvsepp._batch,
            "saem": tsaem._batch}[name]


def _variables(name, cfg, batch) -> dict:
    """`itrx`'s variables as numpy (the BatchNorms' statistics moved off their
    init where the method has them)."""
    if name == "vsrn":
        return tvsrn._init(cfg, batch)
    if name == "camera":
        return tcam.jax_variables(cfg, batch, seed=4)
    jmodel = jget_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.tree.map(np.array, jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, b,
        train=False))(jb)))
    if name == "sgraf_saf":
        variables = tsgraf._perturb_stats(variables, np.random.default_rng(11))
    return variables


_CAMERA_VARIABLES = []


def _camera_variables(cfg, batch) -> dict:
    """CAMERA's variables, initialised once for the tests that only need
    weights of its shapes."""
    if not _CAMERA_VARIABLES:
        _CAMERA_VARIABLES.append(_variables("camera", cfg, batch))
    return _CAMERA_VARIABLES[0]


def _port(cfg, variables):
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    sd = {k: torch.from_numpy(v) for k, v in from_itrx_variables(variables).items()}
    sd.update({k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")})
    model.load_state_dict(sd, strict=True)
    return model


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _adam_mu(opt_state, params):
    """The first moment of optax's Adam (frozen leaves: zeros)."""
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return jax.tree.map(lambda m, p: jnp.zeros_like(p) if isinstance(m, optax.MaskedNode) else m,
                        adam.mu, params, is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def _run(name, tmp):
    """Three updates in both packages from the same weights and batches:
    `itrx`'s bf16 step, the port's bf16 step and the port's fp32 step (the
    reference of bf16's own distance).  Returns a dict of what each test
    reads: the losses, the clipped first gradients (`itrx`'s from its Adam
    first moment, mu = 0.1 g), the statistics after the first update, the
    weights after 1 and 3 updates, and the port's bf16 state."""
    cfg = _cfg(name, tmp)
    fn = _batch_fn(name)
    rng = np.random.default_rng(25)
    variables = _variables(name, cfg, fn(rng))
    batches = [fn(rng) for _ in range(3)]

    jmodel = jget_model(cfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = jstate.make_optimizer(cfg, 2, params)
    jst = jstate.TrainState(params=params,
                            batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})),
                            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    jstep = jloop.make_train_step(jmodel, tx, compute_dtype="bfloat16")
    out = {"cfg": cfg, "jloss": [], "loss": [], "w": {}, "jw": {}}
    for i, b in enumerate(batches, 1):
        jst, aux = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(0), 0)
        out["jloss"].append(float(aux["Loss"]))
        if i in (1, 3):
            jv = {"params": jax.device_get(jst.params)}
            if jst.batch_stats:
                jv["batch_stats"] = jax.device_get(jst.batch_stats)
            out["jw"][i] = from_itrx_variables(jv)
        if i == 1:
            mu = {"params": jax.device_get(_adam_mu(jst.opt_state, jst.params))}
            if jst.batch_stats:
                mu["batch_stats"] = jax.device_get(jst.batch_stats)
            out["jgrad"] = {k: v / 0.1 for k, v in from_itrx_variables(mu).items()}

    for dtype in (BF16, None):
        model = _port(cfg, variables)
        state = create_train_state(model, cfg, steps_per_epoch=2)
        step = make_train_step(state, cfg["seed"], dtype)
        for i, b in enumerate(batches[:3 if dtype else 1], 1):
            aux = step(_t(b), log=True)
            if dtype is None:
                out["grad32"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()
                                 if p.grad is not None}
                out["loss32"] = aux["Loss"]
                continue
            out["loss"].append(aux["Loss"])
            if i == 1:  # the clip scales .grad in place: the clipped gradient
                out["grad"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()
                               if p.grad is not None}
            if i in (1, 3):
                out["w"][i] = {k: v.detach().numpy().copy()
                               for k, v in model.state_dict().items()}
        if dtype is not None:
            out["state"] = state
    return out


@pytest.fixture(scope="module", params=METHODS)
def run(request, tmp_path_factory):
    return request.param, _run(request.param, tmp_path_factory.mktemp(request.param))


def _l2(a, b) -> float:
    return float(np.linalg.norm((a - b).ravel()))


def _scale(r) -> float:
    """The largest L2 norm of `itrx`'s clipped first gradients."""
    return max(float(np.linalg.norm(g)) for k, g in r["jgrad"].items() if k in r["grad"])


def test_first_bf16_step_matches_itrx(run):
    """The first update's loss within LOSS_REL of `itrx`'s bf16 step and
    within 3% of the fp32 step (`itrx`'s own tolerance,
    tests/test_train_bf16.py), and every trained parameter's clipped
    gradient: ||port_bf16 - itrx_bf16|| <= NOISE_K ||port_fp32 - itrx_bf16||
    per tensor (L2), i.e. no further from `itrx`'s bf16 gradient than bf16
    puts the fp32 gradient (the port's fp32 step equals `itrx`'s to 1e-4 of
    scale, tests/test_torch_*train*.py), up to NOISE_FLOOR of the largest
    gradient norm.  Read on the CPU: the loss 7.0e-5 (VSE++) to 4.1e-3
    (SAEM) from `itrx`'s, 4.1e-4 to 4.0e-3 from fp32; the ratio at most 1.13
    (VSE++), 0.27-1.07 elsewhere."""
    name, r = run
    loss, jl = r["loss"][0], r["jloss"][0]
    assert abs(loss - jl) <= LOSS_REL * abs(jl), (name, loss, jl)
    assert abs(loss - r["loss32"]) <= 0.03 * abs(r["loss32"]), (name, loss, r["loss32"])
    assert set(r["grad"]) == set(r["grad32"])
    floor = NOISE_FLOOR * _scale(r)
    worst = {}
    for k, g in r["grad"].items():
        want = r["jgrad"][k]
        noise = _l2(r["grad32"][k], want)
        err = _l2(g, want)
        assert np.isfinite(g).all(), (name, k)
        assert err <= NOISE_K * noise + floor, (name, k, err, noise, floor)
        worst[k] = err / max(noise, 1e-30)
    print(name, "loss", abs(loss - jl) / abs(jl), "worst ratio",
          max(worst.items(), key=lambda kv: kv[1]))


def test_bf16_step_is_not_the_fp32_step(run):
    """The port's bf16 step rounds where a bf16 step rounds: over all trained
    tensors (L2), its clipped first gradients stand at least BF16_APART of
    `itrx`'s bf16 step's distance from the port's fp32 step.  A step that
    ran in fp32 stands at 0, and passes test_first_bf16_step_matches_itrx
    (its ratio is 1).  Read on the CPU: 0.50 (CAMERA) to 1.43 (SCAN)."""
    name, r = run
    keys = sorted(r["grad"])
    own = np.sqrt(sum(_l2(r["grad"][k], r["grad32"][k]) ** 2 for k in keys))
    theirs = np.sqrt(sum(_l2(r["jgrad"][k], r["grad32"][k]) ** 2 for k in keys))
    print(name, "bf16 step's distance from fp32 over itrx's", own / theirs)
    assert own >= BF16_APART * theirs, (name, own, theirs)


def test_bf16_statistics_after_one_update(run):
    """The BatchNorm running statistics after the first update: fp32
    tensors holding bf16 values (the update runs in fp32 and rounds once, as
    `itrx`'s astype), within a few bf16 steps of `itrx`'s (the batch
    statistics come from bf16 activations that differ by rounding; read at
    most 2.1e-2 of scale, VSRN)."""
    name, r = run
    got, want = r["w"][1], r["jw"][1]
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        v = got[k]
        assert v.dtype == np.float32, k
        assert np.array_equal(torch.from_numpy(v).bfloat16().float().numpy(), v), k
        scale = max(float(np.abs(want[k]).max()), 1e-3)
        assert float(np.abs(v - want[k]).max()) <= 2.0 ** -5 * scale, (name, k)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_bf16_weights_after_updates_match_itrx(run, n_steps):
    """The weights after 1 and 3 updates against `itrx`'s bf16 run.  Adam's
    first update is lr * sign(g) where |g| is well above eps, so an entry
    whose gradient sign bf16 flips moves 2 lr apart; every entry stays within
    2 lr a step, and the RMS difference over each tensor whose first gradient
    stands above bf16's own rounding (not EXACT_ZERO, above NOISE_FLOOR)
    within RMS_LR lr a step (read: at most 0.78 lr after one step, CAMERA,
    0.37 a step after three; a noise-level gradient's entries follow their
    noise's sign, 2 lr apart)."""
    name, r = run
    lr = r["cfg"]["learning_rate"]
    floor = NOISE_FLOOR * _scale(r)
    got, want = r["w"][n_steps], r["jw"][n_steps]
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        d = got[k] - w
        assert np.isfinite(got[k]).all(), (name, k)
        assert float(np.abs(d).max()) <= 2 * lr * n_steps + 1e-6, (name, k)
        if k in r["grad"] and not _exact_zero(name, k) and np.linalg.norm(r["jgrad"][k]) > floor:
            rms = float(np.sqrt(np.mean(d * d)))
            assert rms <= RMS_LR * lr * n_steps, (name, k, rms / lr)
    assert all(np.isfinite(v) for v in r["loss"])


def test_masters_and_adam_state_stay_fp32(run):
    """After three bf16 updates every parameter, every buffer that was fp32,
    and every Adam moment is fp32; the frozen BERT (CAMERA, SAEM) took no
    gradient and has no Adam state."""
    name, r = run
    state = r["state"]
    for k, p in state.model.named_parameters():
        assert p.dtype == torch.float32, k
        if not p.requires_grad:
            assert p.grad is None and p not in state.optimizer.state, k
    for k, b in state.model.named_buffers():
        assert b.dtype in (torch.float32, torch.int64), k
    for st in state.optimizer.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert state.step == 3


def test_camera_bf16_thin_box_stays_finite(tmp_path):
    """As tests/test_train_bf16.py::test_camera_bf16_thin_box_stays_finite:
    a thin box high in the image (300.5 - 300.0 rounds to 0 in bf16) keeps
    CAMERA's bf16 steps finite, since the box geometry stays fp32
    (KEEP_F32)."""
    cfg = _cfg("camera", tmp_path)
    rng = np.random.default_rng(3)
    batch = tcam.camera_batch(rng)
    batch["boxes"][0, 0] = [10.0, 300.0, 90.0, 300.5]
    model = _port(cfg, _camera_variables(cfg, batch))
    state = create_train_state(model, cfg, steps_per_epoch=2)
    step = make_train_step(state, cfg["seed"], BF16)
    losses = [step(_t(batch), log=True)["Loss"] for _ in range(3)]
    assert all(np.isfinite(losses)), losses
    assert all(torch.isfinite(p).all() for p in model.parameters())
    # the same boxes cast to bf16 would collapse that box's height
    b16 = torch.from_numpy(batch["boxes"]).bfloat16()
    assert float(b16[0, 0, 3] - b16[0, 0, 1]) == 0.0


def test_cast_loss_writes_the_statistics_back_once_rounded(tmp_path):
    """cast_loss leaves the model's parameters and buffers fp32 and the same
    tensors, writes the bf16 forward's statistics into them, and passes the
    box geometry in fp32 and every other float field (masks too) in bf16."""
    cfg = _cfg("camera", tmp_path)
    batch = tcam.camera_batch(np.random.default_rng(4))
    model = _port(cfg, _camera_variables(cfg, batch)).train()
    before = {k: v.clone() for k, v in model.named_buffers()}
    ids = {k: id(v) for k, v in model.named_buffers()}
    seen = {}
    loss_fn = model.loss

    def spy(b, **kw):
        seen.update({k: v.dtype for k, v in b.items()})
        return loss_fn(b, **kw)

    model.loss = spy
    loss, _ = cast_loss(model, _t(batch), 0, BF16)
    del model.loss
    assert loss.dtype == torch.float32
    assert seen["boxes"] == seen["imgs_wh"] == torch.float32
    assert seen["images"] == seen["cap_mask"] == BF16
    assert seen["cap_ids"] == torch.int32
    for k, v in model.named_buffers():
        assert id(v) == ids[k] and v.dtype == before[k].dtype, k
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(v, before[k]), k
            assert torch.equal(v.bfloat16().float(), v), k
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_fit_bf16_checkpoints_and_resumes(tmp_path):
    """A tiny SCAN fit with train_bf16 on the CPU (check_supported accepts
    it): finite losses, fp32 weights in the checkpoints, evalrank_single on
    model_best reproducing best_rsum, and a resume from the last epoch's
    checkpoint (the checkpoint's epoch is run again on resume, as in the
    JAX package, so num_epochs 1 leaves nothing to train) ending on the
    uninterrupted run's weights and Adam moments bit for bit; with num_epochs
    2 it trains that epoch again in bf16."""
    import os

    from itrx_torch.configs import parse_cli
    from itrx_torch.data import synthetic
    from itrx_torch.eval.engine import evalrank_single

    d = synthetic.generate(str(tmp_path / "synthetic"), n_images=24, img_dim=48)

    def cfg_of(save, **kw):
        args = dict(data_path=str(tmp_path), data_name="synthetic", vocab_path=f"{d}/vocab",
                    vocab_type="json", img_dim=48, embed_size=32, word_dim=16, batch_size=24,
                    num_epochs=2, val_step=3, log_step=1, learning_rate=0.01,
                    save_path=str(tmp_path / save), max_violation=False, seed=3,
                    train_bf16=True)
        args.update(kw)
        return parse_cli(["with", "SCAN"] + [f"{k}={v}" for k, v in args.items()])

    cfg = cfg_of("runs")
    state, best_rsum = fit(cfg, device="cpu")
    assert state.step == 10
    best = os.path.join(cfg["save_dir"], "model_best.pth.tar")
    ck = load_checkpoint(best)
    assert all(v.dtype == torch.float32 for part in ck["model"] for v in part.values())
    assert evalrank_single(best, split="dev", device="cpu")["rsum"] == pytest.approx(
        ck["best_rsum"], abs=1e-9)
    last = os.path.join(cfg["save_dir"], "epo1_checkpoint.pth.tar")
    resumed, _ = fit(cfg_of("resumed", resume=last, num_epochs=1), device="cpu")
    assert resumed.step == state.step
    for (k, a), b in zip(state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.state.values(), resumed.optimizer.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    more, _ = fit(cfg_of("more", resume=last), device="cpu")
    assert more.step == state.step + 5
    assert all(torch.isfinite(p).all() and p.dtype == torch.float32
               for p in more.model.parameters())
