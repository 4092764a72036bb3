"""Trust: secure aggregation and differential privacy."""
