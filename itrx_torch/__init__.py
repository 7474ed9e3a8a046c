"""PyTorch + CUDA port of itrx for NVIDIA Hopper (H100).

The JAX package `itrx` is the reference; this package mirrors its module
names (`itrx_torch.ops.rnn` <-> `itrx.ops.rnn`, ...).  It reuses
`itrx.configs` and `itrx.data` as they are, since neither imports JAX, and
never imports `jax` itself.

Ported so far: SCAN t2i evaluation (`models.get_model` ->
`eval.engine.encode_data` -> `eval.engine.cal_sims` ->
`eval.metrics.cal_recall`; `eval.engine.evalrank_single`) and SCAN training
(`train.loop.fit`: the hinge loss, Adam with clip and step decay,
validation, `.pth.tar` checkpoints in the original reference's layout),
with three hand-written CUDA kernels: the masked GRU forward and its
adjoint (`ops.kernels.gru`) and the t2i score grid (`ops.kernels.xattn`);
sources in `csrc/`.  Entry points: `python -m itrx_torch.train` and
`python -m itrx_torch.eval`.
"""
