"""Utilities: ``jax_params`` (carry JAX numpy trees into the port),
``misc`` (device specs, links), ``visualize`` (overlays, the IoU table)."""
