"""Observability: machine profiles for the planner (the rest of
``repro.obs`` -- spans, metrics, calibration -- is a later slice)."""
from .profile import LinkParams, MachineProfile, default_profile

__all__ = ["LinkParams", "MachineProfile", "default_profile"]
