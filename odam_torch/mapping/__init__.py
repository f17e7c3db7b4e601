"""Superquadric state, scene constraints, scale prior, the solve and the merge."""
