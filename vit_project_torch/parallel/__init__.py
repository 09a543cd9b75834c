"""Multi-process parallelism over ``torch.distributed``: the data, tensor,
expert, sequence and stage axes, ring attention and the GPipe pipeline
(counterpart of the JAX package's parallel/)."""
