"""Compute ops: intersection (jnp oracle + the Pallas kernel for the GPU)."""
