"""Models: configs, the dense decoder LM and the registry."""
