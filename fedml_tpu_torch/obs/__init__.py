"""Observability of the port (JSONL metrics logger)."""
