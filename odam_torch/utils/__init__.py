"""Box and geometry helpers, device and exact host versions."""
