"""Training of the port's classifiers: objective, checkpoints, Trainer."""
