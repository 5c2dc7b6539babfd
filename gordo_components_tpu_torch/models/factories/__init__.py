"""Model factories of the port; importing this package registers them."""

from . import feedforward, lstm, transformer  # noqa: F401
