"""Utilities (``jax_params``: carry JAX numpy trees into the port)."""
