"""The GRU kernels' launch plan (itrx_torch/ops/kernels/gru.py::plan): a pure
function of (batch, hidden, dtype, direction) that chooses the hidden units
a block, the blocks, the resident or streamed route of the weight slice, the
batch chunks and the dynamic shared memory of the persistent kernels
(csrc/gru.cu, csrc/gru_bwd.cu).  CPU only: it reads no card."""

import functools

import pytest
import torch

from itrx_torch import configs
from itrx_torch.models import get_model
from itrx_torch.ops.kernels import gru
from itrx_torch.ops.rnn import MaskedGRU

# batch rows a call takes on the main paths: a full batch (batch_size 128),
# the last batch of encode's 128-row batches over 5000 captions, one row
BATCHES = (128, 5000 % 128, 1)
# (W_hh dtype, adjoint): encode's (and train_bf16's) bf16 forward, the fp32
# forward, the fp32 adjoint, train_bf16's bf16 adjoint
MODES = ((torch.bfloat16, False), (torch.float32, False), (torch.float32, True),
         (torch.bfloat16, True))


@functools.cache
def config_widths() -> tuple:
    """The hidden widths of every MaskedGRU that the overlays of the methods
    with a GRU build (SCAN one-way and bi-GRU, SGRAF, VSRN: its text and
    region GRUs and the caption model's; VSE++'s text GRU; SAEM's rnn heads,
    over BERT's last layer and over the regions), read off the models on the
    meta device."""
    widths = set()
    for overlay, extra in ((configs.SCAN, {}), (configs.SCAN, {"bi_gru": True}),
                           (configs.SGRAF, {}), (configs.VSRN, {}), (configs.VSE_PP, {}),
                           (configs.SAEM, {"txt_stru": "rnn", "img_stru": "rnn",
                                           "bi_gru": True})):
        cfg = configs.base_config()
        cfg.update(overlay())
        cfg.update(extra, vocab_size=100)
        with torch.device("meta"):
            model = get_model(cfg, device="meta", generator=torch.Generator().manual_seed(0))
        widths |= {m.hidden_size for m in model.modules() if isinstance(m, MaskedGRU)}
    return tuple(sorted(widths))


def test_config_widths_are_the_known_ones():
    """SCAN, SGRAF and VSE++ embed 1024; VSRN embed 2048 and dim_hidden 512;
    SAEM's text rnn head embed_size 1024, its image rnn head final_dims
    256."""
    assert config_widths() == (256, 512, 1024, 2048)


@pytest.mark.parametrize("dtype,backward", MODES)
@pytest.mark.parametrize("batch", BATCHES)
def test_every_config_shape_fits_one_h100(batch, dtype, backward):
    for hidden in config_widths():
        p = gru.plan(batch, hidden, dtype, backward=backward)
        assert p.smem <= 232_448 and 1 <= p.blocks <= 132, (hidden, p)
        assert p.units in gru.UNITS and p.route in ("resident", "streamed")
        assert p.k_padded % gru.K_ALIGN == 0 and p.k_padded >= (3 if backward else 1) * hidden


@pytest.mark.parametrize("hidden,dtype,backward,route,smem", [
    (1024, torch.bfloat16, False, "resident", 24 * (1024 + 32) * 2),
    (1024, torch.float32, False, "resident", 24 * (1024 + 4) * 4),
    (1024, torch.float32, True, "resident", 8 * (3072 + 4) * 4),
    (2048, torch.bfloat16, False, "resident", 48 * (2048 + 32) * 2),
    (2048, torch.float32, False, "streamed", 4 * 48 * (64 + 4) * 4),
    (2048, torch.float32, True, "streamed", 4 * 16 * (64 + 4) * 4),
    (512, torch.float32, True, "resident", 8 * (1536 + 4) * 4),
    (1152, torch.float32, True, "resident", 16 * (3456 + 4) * 4),
    (1152, torch.float32, False, "resident", 48 * (1152 + 4) * 4),
    (1216, torch.float32, False, "streamed", 4 * 48 * (64 + 4) * 4),
    # the bf16 adjoint (train_bf16): resident at every width, VSRN's too
    (256, torch.bfloat16, True, "resident", 8 * (768 + 32) * 2),
    (1024, torch.bfloat16, True, "resident", 8 * (3072 + 32) * 2),
    (2048, torch.bfloat16, True, "resident", 16 * (6144 + 32) * 2),
])
def test_route_and_shared_memory(hidden, dtype, backward, route, smem):
    """A slice stays resident while it fits; past 1152 units at 16 a block
    the fp32 slices (VSRN's H 2048 training GRUs: 393 KB a block) stream
    through the ring.  The bf16 adjoint's slices fit at every width: 49,664
    B a block at H 1024 (8 units), 197,632 B at H 2048 (16 units)."""
    p = gru.plan(128, hidden, dtype, backward=backward)
    assert (p.route, p.smem) == (route, smem)


@pytest.mark.parametrize("hidden", [300, 512, 1024, 1036, 1057, 2048, 2112])
def test_unit_groups_cover_h_once(hidden):
    """Block i owns units [i U, (i + 1) U) of H: together once each, and no
    block without a unit (1036: H not a multiple of the group; 1057: the
    first width past 8 units on 132 SMs)."""
    for dtype, backward in MODES:
        p = gru.plan(128, hidden, dtype, backward=backward)
        owned = [j for i in range(p.blocks) for j in range(i * p.units, (i + 1) * p.units)
                 if j < hidden]
        assert owned == list(range(hidden))
        assert (p.blocks - 1) * p.units < hidden
    assert gru.plan(1, 1056, torch.float32).units == 8
    assert gru.plan(1, 1057, torch.float32).units == 16


@pytest.mark.parametrize("batch", [1, 8, 127, 128, 129, 300, 5000])
def test_batch_chunks_cover_b_once(batch):
    p = gru.plan(batch, 1024, torch.bfloat16)
    rows = [b for b0, b1 in p.chunks for b in range(b0, b1)]
    assert rows == list(range(batch))
    assert all(0 < b1 - b0 <= gru.ROWS for b0, b1 in p.chunks)
    assert len(p.chunks) == -(-batch // gru.ROWS)


def test_plan_follows_the_cards_sm_count():
    assert gru.plan(128, 1024, torch.float32, sms=114).units == 16
    assert gru.plan(128, 1024, torch.float32, sms=132).blocks == 128


@pytest.mark.parametrize("batch,hidden,dtype,backward", [
    (128, 16 * 132 + 1, torch.bfloat16, False),  # more units than the SMs hold
    (0, 1024, torch.float32, False),
    (128, 0, torch.float32, False),
    (128, 1024, torch.float16, False),
    (128, 1024, torch.float16, True),  # the adjoint takes fp32 or bf16
])
def test_impossible_requests_raise(batch, hidden, dtype, backward):
    with pytest.raises(ValueError, match="GRU plan"):
        gru.plan(batch, hidden, dtype, backward=backward)
