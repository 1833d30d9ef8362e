"""Experiment registry (``registry.get_experiment``, ``registry.build_model``)."""
