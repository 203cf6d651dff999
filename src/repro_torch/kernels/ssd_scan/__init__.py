"""Mamba-2 SSD scan of the hybrid family's prefill: ``kernel`` (CUDA
wrapper), ``ops`` (dispatch), ``ref`` (plain PyTorch versions)."""
