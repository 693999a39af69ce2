"""osdc — the client op engine (src/osdc/)."""

from .objecter import (
    Objecter,
    ObjecterError,
    ObjectNotFound,
    RadosError,
    object_to_pg,
)

__all__ = [
    "Objecter",
    "ObjecterError",
    "ObjectNotFound",
    "RadosError",
    "object_to_pg",
]
