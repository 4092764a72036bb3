"""Data layer of the port: loaders, partitioners, client stacking (numpy)."""
