"""Layer library; every projection goes through ``linear`` -> the Z-order kernel."""
