"""The online per-frame pipeline and its track store."""
