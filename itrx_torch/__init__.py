"""PyTorch + CUDA port of itrx for NVIDIA Hopper (H100).

The JAX package `itrx` is the reference; this package mirrors its module
names (`itrx_torch.ops.rnn` <-> `itrx.ops.rnn`, ...).  It imports nothing of
`itrx` and never imports `jax`: the config and data modules it needs
(`configs`, `data.precomp` with `vocab`, `treebank`, `tokenization`,
`data.synthetic`, `utils.logging`) are its own copies, and it reads only the
two vocabularies shipped in `itrx/vocab/`, as data files.

Ported so far: SCAN evaluation in both directions (`models.get_model` ->
`eval.engine.encode_data` -> `eval.engine.cal_sims` ->
`eval.metrics.cal_recall`; `eval.engine.evaluate_split` with fold5,
`evalrank_single` and the two-checkpoint `evalrank_ensemble`) and SCAN
training (`train.loop.fit`: the hinge loss, Adam with clip and step decay,
validation, `.pth.tar` checkpoints in the original reference's layout),
with four hand-written CUDA kernels: the masked GRU forward and its adjoint
(`ops.kernels.gru`) and the t2i and i2t score grids (`ops.kernels.xattn`);
sources in `csrc/`.  The entry points run on cuda:0 unless the caller passes
another device (the CPU tests pass `device="cpu"`).  Command lines:
`python -m itrx_torch.train` and `python -m itrx_torch.eval`.
"""
