"""The pipeline (per-frame step, scene-end mapping and merge) and its track store."""
