"""Training engine: learning-rate schedules, SGD parameter groups,
trainer, evaluator, checkpoints (``checkpoint``: ``torch.save`` snapshots;
``checkpoint_orbax``: atomic, asynchronous, keep-N DCP checkpoints), and
the reference's ``Engine`` facade over them (``engine``)."""
