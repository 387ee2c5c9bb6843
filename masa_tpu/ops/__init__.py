"""Compute kernels: NumPy oracle, the wavefront strip (CUDA kernel and its
lax.scan twin), row sweep, small-matrix DP."""
