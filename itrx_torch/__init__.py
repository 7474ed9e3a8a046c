"""PyTorch + CUDA port of itrx for NVIDIA Hopper (H100).

The JAX package `itrx` is the reference; this package mirrors its module
names (`itrx_torch.ops.rnn` <-> `itrx.ops.rnn`, ...).  It reuses
`itrx.configs` and `itrx.data` as they are, since neither imports JAX, and
never imports `jax` itself.

The slice ported so far is SCAN t2i evaluation:
`models.get_model` -> `eval.engine.encode_data` -> `eval.engine.cal_sims`
-> `eval.metrics.cal_recall`, with two hand-written CUDA kernels
(`ops.kernels.gru`, `ops.kernels.xattn`; sources in `csrc/`).
"""
