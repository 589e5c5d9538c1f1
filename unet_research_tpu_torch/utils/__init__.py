"""Parameter and checkpoint conversion."""
