"""Runtime: the serving decode loop and the trainer."""
