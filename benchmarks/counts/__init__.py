"""Frozen operation and byte counts: the numerators of the rooflines."""
