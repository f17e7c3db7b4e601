"""Attention kernels, optimal transport, assignment and surface sampling."""
