"""Measurement tools of the port, run on the card (each a `python -m` entry)."""
