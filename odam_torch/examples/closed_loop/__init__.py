"""The segmented closed loop: a DETR trained from scratch on a synthetic
3-object scene, then detection, tracking, mapping and IoU against ground
truth on held-out views."""
