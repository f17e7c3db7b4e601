"""Superquadric and dual-quadric state, scene constraints, scale prior, the solves and the merge."""
