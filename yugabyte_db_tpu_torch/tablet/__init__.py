from .tablet import Tablet  # noqa: F401
