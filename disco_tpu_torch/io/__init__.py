from .readstore import ReadStore  # noqa: F401
