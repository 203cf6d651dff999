"""PyTorch/CUDA port of the serving stack, for NVIDIA Hopper (H100).

Module names mirror ``repro`` (the JAX reference) so each counterpart is
easy to find.  The package imports ``torch`` and numpy only.  Every entry
point takes an explicit ``device``: it runs on ``cuda`` unless the caller
passes ``device="cpu"``, and raises when the card is asked for and absent.
On a CUDA tensor the attention goes through the hand-written kernels under
``repro_torch.kernels``; on a CPU tensor it takes their plain versions.
"""
