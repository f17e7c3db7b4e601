from . import distributed, mesh  # noqa: F401
