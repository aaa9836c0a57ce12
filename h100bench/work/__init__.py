"""The frozen operation and byte counts (see counts.py)."""
