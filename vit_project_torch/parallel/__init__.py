"""Multi-process parallelism over ``torch.distributed``: the data, tensor,
expert and sequence axes and ring attention (counterpart of the JAX
package's parallel/)."""
