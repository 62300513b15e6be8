"""Optimizers (counterpart of ``repro.optim``): AdamW so far."""
