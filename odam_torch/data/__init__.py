"""ScanNet IO, frame loading, resize, transport and normalisation."""
