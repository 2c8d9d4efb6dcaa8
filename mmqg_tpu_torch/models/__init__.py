"""Model modules of the port, in the JAX package's parameter layouts."""
