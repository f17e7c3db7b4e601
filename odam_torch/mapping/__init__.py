"""Superquadric object state."""
