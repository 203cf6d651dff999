"""GQA flash-attention forward (prefill): ``kernel`` (CUDA wrapper), ``ops``
(dispatch), ``ref`` (plain PyTorch versions)."""
