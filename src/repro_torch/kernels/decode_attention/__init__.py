"""Flash-decoding attention: ``kernel`` (CUDA wrappers), ``ops`` (dispatch),
``ref`` (plain PyTorch versions)."""
