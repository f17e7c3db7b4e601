"""Attention, LAP, Sinkhorn and MSDA kernel wrappers with the seam that builds, launches and counts them (kernels), assignment and surface sampling."""
