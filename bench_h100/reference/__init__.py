"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
with nothing of ``odam_torch`` imported."""
