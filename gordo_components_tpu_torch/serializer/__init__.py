"""Serializer of the port: the reference's artifact format, read and written
without the reference package."""

from .from_definition import pipeline_from_definition  # noqa: F401
from .into_definition import pipeline_into_definition  # noqa: F401
from .persistence import METADATA_FILE, dump, load, load_metadata  # noqa: F401
