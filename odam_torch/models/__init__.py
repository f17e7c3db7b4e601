"""DETR detector, associator, and the weight bridge from Flax."""
