"""Box and geometry helpers."""
