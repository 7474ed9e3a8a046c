"""CAMERA's training and evaluation slices from one checkout, for comparing
two trees on the card.

    python3 itrx_torch/tools/camera_ab.py TREE

Run it by path, not with `-m`: it puts TREE (a checkout of this repository,
for example an earlier commit unpacked with `git archive`) first on the
import path and imports that tree's chip_smoke.py and itrx_torch, so the
same command measures either tree.  It builds TREE's two AGSA kernels, runs
chip_smoke.py's CAMERA training slice (`phase_train(..., "camera")`: the
first-step witnesses, one 25-step epoch, the median step and a profile over
3 steps) and its CAMERA evaluation slice (`phase_slice(..., "camera")`, on
the f30k-1K-shaped synthetic split), and prints one line, `AB_RESULT`
followed by JSON: the card, the median step seconds and every step's, the
profile's wall and device ms and idle share, the kernel-vs-plain gradient
witness and the encode seconds.  Compare two trees in one call, in turns
(parent, change, change, parent).  Needs a CUDA card.
"""

from __future__ import annotations


def main() -> None:
    import json
    import os
    import sys
    import tempfile
    import time

    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from itrx_torch.ops import kernels

    card = cs.phase_device()
    t0 = time.time()
    for name in ("agsa_attn", "agsa_attn_bwd"):
        kernels.build(name)
    out = {"tree": sys.argv[1], "card": card, "build_s": round(time.time() - t0, 1)}
    with tempfile.TemporaryDirectory(prefix="camera_ab_train_") as root:
        tr = cs.phase_train(root, card, "camera")
    out["step_seconds_median"] = tr["step_seconds_median"]
    out["step_seconds"] = tr["step_seconds"]
    out["profile"] = {k: tr["profile"][k] for k in ("steps", "wall_ms", "device_ms", "idle_share")
                      if k in tr["profile"]}
    out["kernel_grad_rel_err_max"] = tr["witness"]["kernel_grad_rel_err_max"]
    with tempfile.TemporaryDirectory(prefix="camera_ab_eval_") as data_root:
        cs.generate(os.path.join(data_root, "f30k_precomp"), n_images=4000, img_dim=2048,
                    splits=("test",), seed=0, n_concepts_range=(2, 10))
        cs.write_tiny_bert_vocab(os.path.join(data_root, "vocab.txt"))
        cam, _ = cs.phase_slice(data_root, card, "camera")
    out["encode_seconds"] = cam["encode_seconds"]
    print("AB_RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
