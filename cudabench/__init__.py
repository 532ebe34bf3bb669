"""The benchmark of the PyTorch and CUDA port; `python3 -m cudabench.run`
runs one cell."""

# What no run may hold in `sys.modules` once its window closes, by whole
# top-level name: JAX, and the JAX package beside the port (whose name the
# port's begins with).
FORBIDDEN = ("jax", "jaxlib", "flax", "sopro_tpu")
