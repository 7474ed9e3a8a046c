"""Evaluation engine and ranking metrics of the port."""
