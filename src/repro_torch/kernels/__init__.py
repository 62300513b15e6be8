"""Kernels written by hand for Hopper, one package per TPU kernel ported."""
