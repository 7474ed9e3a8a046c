"""Tensor ops of the port (counterparts of `itrx.ops`)."""
