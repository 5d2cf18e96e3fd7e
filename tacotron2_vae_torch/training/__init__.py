"""Training: loss, train state and steps, checkpoints, CSV logs, CLI."""
