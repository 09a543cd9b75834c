"""Dataset constants the port needs (values of the JAX package's core/configs.py)."""

# THINGS image normalization (exact values from the reference).
THINGS_MEAN = (0.52997664, 0.48070561, 0.41943838)
THINGS_STD = (0.27608301, 0.26593025, 0.28238822)
