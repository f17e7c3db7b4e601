"""Attention and LAP kernels with their builder, optimal transport, assignment and surface sampling."""
