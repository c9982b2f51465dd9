"""Transaction generators, one module per kind a configuration names."""
