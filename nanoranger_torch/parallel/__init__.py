from . import sharded  # noqa: F401
