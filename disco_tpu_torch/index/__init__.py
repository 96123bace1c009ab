from .table import FingerprintTable  # noqa: F401
