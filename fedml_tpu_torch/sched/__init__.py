"""Scheduling: the group assignments of the hierarchical simulator."""
