"""Training of the port: AdamW, the accumulating train step, the data
pipeline and checkpoints (counterparts of the JAX package's ``training``)."""
