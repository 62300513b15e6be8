"""Data pipelines (counterpart of ``repro.data``)."""
