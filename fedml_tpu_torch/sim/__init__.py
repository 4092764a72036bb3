"""The port's simulators."""
