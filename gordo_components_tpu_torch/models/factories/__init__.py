"""Model factories of the port; importing this package registers them."""

from . import transformer  # noqa: F401
