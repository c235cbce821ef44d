"""On-disk size of a needle record in a volume's .dat (reference
needle.go): header, body, checksum, the version 3 timestamp, and padding
to the 8-byte needle alignment. ec.decode sizes the .dat it writes back
from the .ecx entries with it."""

from __future__ import annotations

from .types import (NEEDLE_CHECKSUM_SIZE, NEEDLE_HEADER_SIZE,
                    NEEDLE_PADDING_SIZE, TIMESTAMP_SIZE, VERSION3)


def padding_length(needle_size: int, version: int) -> int:
    base = NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE
    if version == VERSION3:
        base += TIMESTAMP_SIZE
    return NEEDLE_PADDING_SIZE - (base % NEEDLE_PADDING_SIZE)


def needle_body_length(needle_size: int, version: int) -> int:
    extra = TIMESTAMP_SIZE if version == VERSION3 else 0
    return (needle_size + NEEDLE_CHECKSUM_SIZE + extra
            + padding_length(needle_size, version))


def get_actual_size(size: int, version: int) -> int:
    """Bytes a needle of ``size`` data bytes takes in the .dat."""
    return NEEDLE_HEADER_SIZE + needle_body_length(size, version)
