"""Measurement tools of the port (run on a CUDA card)."""
