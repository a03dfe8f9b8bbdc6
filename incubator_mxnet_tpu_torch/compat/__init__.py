"""File formats shared with the reference and the JAX package."""
