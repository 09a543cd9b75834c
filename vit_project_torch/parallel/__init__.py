"""Multi-process data parallelism over ``torch.distributed`` (counterpart of
the JAX package's parallel/)."""
