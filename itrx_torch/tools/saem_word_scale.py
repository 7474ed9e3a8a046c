"""SAEM's evaluation slice under ways of preparing its random weights, for
choosing the preparation that lets the slice's witness tell a right grid
from a degenerate one.

    python3 itrx_torch/tools/saem_word_scale.py

Run it by path from the root of a checkout.  It writes chip_smoke.py's
f30k-1K-shaped synthetic split (1000 images x 36 x 2048, 5000 captions, the
tiny BERT vocabulary) and, for the SAEM() overlay and again with both rnn
heads (bi_gru), builds the slice's seeded model, prepares it (BERT's word
embeddings times `k`; with the cnn text head, each convolution's bias set
to -t times its filter's norm) and encodes the split in fp32 and in bf16 as
`evaluate_split` does.  One line a preparation: the captions' mean cosine,
the fp32 grid's distinct top-1 images, the bf16 grid's top-1 agreement with
the fp32 grid's, the share of captions whose fp32 top-1 is among the bf16
top 5, the grid's and the embeddings' largest bf16 differences, and the fp32
rsum.  Needs a CUDA card.
"""

from __future__ import annotations


def main() -> None:
    import os
    import sys
    import tempfile

    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from itrx_torch.data.precomp import get_test_loader
    from itrx_torch.data.synthetic import generate, write_tiny_bert_vocab
    from itrx_torch.eval import engine, metrics

    root = tempfile.mkdtemp()
    generate(os.path.join(root, "f30k_precomp"), n_images=4000, img_dim=2048, splits=("test",),
             seed=0, n_concepts_range=(2, 10))
    write_tiny_bert_vocab(os.path.join(root, "vocab.txt"))

    def prepare(model, t, k) -> None:
        with torch.no_grad():
            model.txt_enc.bert.embeddings.word_embeddings.weight.mul_(k)
            if t is not None and hasattr(model.txt_enc, "convs1"):
                for conv in model.txt_enc.convs1:
                    conv.bias.copy_(-t * conv.weight.flatten(1).norm(dim=1))

    runs = (((), [(None, 1), (None, 10), (0.4, 1), (0.4, 10), (0.8, 1), (0.8, 10), (1.2, 10)]),
            (("txt_stru=rnn", "img_stru=rnn", "bi_gru=True"), [(None, 1), (None, 10)]))
    for extra, variants in runs:
        cfg = cs.eval_config(root, "f30k_precomp", "SAEM", f"bert_path={root}", *extra)
        ds, vocab_size = get_test_loader("test", cfg)
        cfg["vocab_size"] = vocab_size
        for t, k in variants:
            model = cs.seeded_model(cfg, cfg["seed"])
            prepare(model, t, k)
            e32 = engine.encode_data(model, ds, 128, device=cs.DEV)
            e16 = cs.encode(model, ds, cfg)
            s32 = engine.cal_sims(model, e32["img"][::ds.im_div], e32["cap"], verbose=False)
            s16 = cs.grid_of(model, e16, ds.im_div)
            err, agree, _ = cs._top1(s16, s32)
            cap = e32["cap"]
            n = cap.shape[0]
            cos = float(((cap @ cap.t()).sum() - n) / (n * n - n))
            dc = (e16["cap"].float() - e32["cap"]).norm(dim=1)
            di = (e16["img"].float() - e32["img"]).norm(dim=1)
            top5 = s16.topk(5, dim=0).indices
            in5 = float((top5 == s32.argmax(0)[None]).any(0).float().mean())
            rsum = metrics.cal_recall(s32, cap_ratio=ds.im_div, verbose=False)["rsum"]
            print(extra, f"shift {t} word x{k}: cap cos {cos:.4f} distinct32 "
                  f"{int(torch.unique(s32.argmax(0)).numel())} agree {agree:.4f} in_top5 "
                  f"{in5:.4f} grid err {err:.4g} cap err mean {float(dc.mean()):.4g} max "
                  f"{float(dc.max()):.4g} img err max {float(di.max()):.4g} emb maxabs cap "
                  f"{float((e16['cap'].float() - e32['cap']).abs().max()):.4g} rsum32 {rsum:.2f}",
                  flush=True)


if __name__ == "__main__":
    main()
