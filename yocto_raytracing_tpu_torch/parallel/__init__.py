"""Training over the scene leaves (single device)."""
