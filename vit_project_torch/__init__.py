"""PyTorch / CUDA port of vit_project_tpu, for NVIDIA Hopper GPUs.

Module paths mirror the JAX package's, so each counterpart is found by path.
The port imports neither JAX nor the JAX package.
"""
