from . import hints, specs  # noqa: F401
