"""Scan2CAD evaluation."""
