from . import spec, types
from .blockindex import BlockIndex
from .reader import Reader, open  # noqa: A004
from .writer import Writer, create
