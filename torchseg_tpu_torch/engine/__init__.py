"""Training engine: learning-rate schedules, SGD parameter groups, trainer."""
