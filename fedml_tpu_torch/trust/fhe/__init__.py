"""Homomorphic encryption for federated aggregation (host numpy)."""
