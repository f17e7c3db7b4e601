"""Frame transport and normalisation."""
