"""Utilities: ``jax_params`` (JAX numpy trees into the port and back),
``torch_convert`` (reference ``.pth`` checkpoints), ``gluon_convert``
(GluonCV ``.params``), ``misc`` (device specs, links), ``visualize``
(overlays, the IoU table)."""
