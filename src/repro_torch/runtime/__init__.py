"""Runtime: the serving decode loop."""
