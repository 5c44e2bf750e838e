"""Training: optimizer, schedule, freezing, the train step and its CLI."""
