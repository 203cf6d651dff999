"""Row RMSNorm with an optional fused residual add: ``kernel`` (CUDA
wrapper), ``ops`` (dispatch), ``ref`` (plain PyTorch version)."""
