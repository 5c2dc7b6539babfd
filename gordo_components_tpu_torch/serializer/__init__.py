"""Serializer of the port: the reference's artifact format, read and written
without the reference package."""

from .from_definition import pipeline_from_definition  # noqa: F401
from .into_definition import into_definition_yaml, pipeline_into_definition  # noqa: F401
from .persistence import (  # noqa: F401
    METADATA_FILE,
    dump,
    dumps,
    load,
    loads,
    load_metadata,
    write_artifact_files,
)
