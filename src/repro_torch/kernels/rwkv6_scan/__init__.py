"""WKV6 recurrence of the rwkv6 time mix: ``kernel`` (CUDA wrapper), ``ops``
(dispatch), ``ref`` (plain PyTorch versions)."""
