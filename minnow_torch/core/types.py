"""Group type enum, dtype tables and runtime type checking.

Mirrors the reference's type system (ref go/group.go:11-75): twelve group
types -- ten raw fixed-size dtypes, the bit-packed integer group and the
quantized float group -- plus the container magic/version constants
(ref go/minnow.go:7-8).

The port's own copy of ``minnow_tpu/core/types.py``: the same arithmetic
and the same bytes, on numpy, with no import from that package.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0xACEDAD
VERSION = 1

INT64_GROUP = 0
INT32_GROUP = 1
INT16_GROUP = 2
INT8_GROUP = 3
UINT64_GROUP = 4
UINT32_GROUP = 5
UINT16_GROUP = 6
UINT8_GROUP = 7
FLOAT64_GROUP = 8
FLOAT32_GROUP = 9
INT_GROUP = 10
FLOAT_GROUP = 11

GROUP_NAMES = [
    "Int64Group",
    "Int32Group",
    "Int16Group",
    "Int8Group",
    "Uint64Group",
    "Uint32Group",
    "Uint16Group",
    "Uint8Group",
    "Float64Group",
    "Float32Group",
    "IntGroup",
    "FloatGroup",
]

# Bytes per element for the ten fixed-size group types
# (ref go/group.go:73-75).
FIXED_SIZE_BYTES = [8, 4, 2, 1, 8, 4, 2, 1, 8, 4]

# Little-endian numpy dtypes for the fixed-size group types.
FIXED_SIZE_DTYPES = [
    np.dtype("<i8"),
    np.dtype("<i4"),
    np.dtype("<i2"),
    np.dtype("<i1"),
    np.dtype("<u8"),
    np.dtype("<u4"),
    np.dtype("<u2"),
    np.dtype("<u1"),
    np.dtype("<f8"),
    np.dtype("<f4"),
]

# numpy dtype accepted for each of the 12 group types.  IntGroup carries
# int64 data, FloatGroup carries float32 data (ref go/group.go:43-71).
_GROUP_DTYPE = {
    INT64_GROUP: np.dtype(np.int64),
    INT32_GROUP: np.dtype(np.int32),
    INT16_GROUP: np.dtype(np.int16),
    INT8_GROUP: np.dtype(np.int8),
    UINT64_GROUP: np.dtype(np.uint64),
    UINT32_GROUP: np.dtype(np.uint32),
    UINT16_GROUP: np.dtype(np.uint16),
    UINT8_GROUP: np.dtype(np.uint8),
    FLOAT64_GROUP: np.dtype(np.float64),
    FLOAT32_GROUP: np.dtype(np.float32),
    INT_GROUP: np.dtype(np.int64),
    FLOAT_GROUP: np.dtype(np.float32),
}

_FIXED_TYPE_BY_DTYPE = {
    np.dtype(np.int64): INT64_GROUP,
    np.dtype(np.int32): INT32_GROUP,
    np.dtype(np.int16): INT16_GROUP,
    np.dtype(np.int8): INT8_GROUP,
    np.dtype(np.uint64): UINT64_GROUP,
    np.dtype(np.uint32): UINT32_GROUP,
    np.dtype(np.uint16): UINT16_GROUP,
    np.dtype(np.uint8): UINT8_GROUP,
    np.dtype(np.float64): FLOAT64_GROUP,
    np.dtype(np.float32): FLOAT32_GROUP,
}


def group_dtype(group_type: int) -> np.dtype:
    """numpy dtype of the user-facing data for a group type."""
    return _GROUP_DTYPE[int(group_type)]


def fixed_group_for_dtype(dtype) -> int:
    """The fixed-size group type enum for a raw numpy dtype."""
    return _FIXED_TYPE_BY_DTYPE[np.dtype(dtype)]


def type_match(x, group_type: int) -> None:
    """Raise TypeError if array ``x`` cannot be stored in / read from a group
    of type ``group_type`` (ref go/group.go:43-71, TypeMatch)."""
    gt = int(group_type)
    if gt not in _GROUP_DTYPE:
        raise TypeError("Unrecognized group type, %d." % gt)
    want = _GROUP_DTYPE[gt]
    got = np.asarray(x).dtype
    if got != want:
        raise TypeError(
            "Got type []%s for group %s (expected []%s)."
            % (got.name, GROUP_NAMES[gt], want.name)
        )


def is_fixed(group_type: int) -> bool:
    return INT64_GROUP <= int(group_type) <= FLOAT32_GROUP
