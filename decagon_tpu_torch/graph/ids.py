"""Typed node identifiers with lossless STITCH string round-trips.

The port's copy of ``decagon_tpu/graph/ids.py``, unchanged.

Behavioral spec: reference ``main/Dtos/NodeIds.py:29-76`` — IDs parse by
stripping letters and leading zeros ("CID000012314" -> 12314), and format
back to the STITCH scheme (drugs: "CID" + 9 digits; side effects:
"C" + 7 digits; proteins: plain integer string).  The reference's
``_formatStr`` collapses any string *ending* in '0' to 0 (a bug); the
intent — digits minus leading zeros — is implemented here instead.
"""

from __future__ import annotations

import re

_NON_DIGITS = re.compile(r"\D")


def _parse_stitch(value: object) -> int:
    """Strip non-digits and leading zeros from a STITCH-style ID string."""
    if isinstance(value, int):
        return value
    digits = _NON_DIGITS.sub("", str(value)).lstrip("0")
    return int(digits) if digits else 0


class BaseNodeId(int):
    """Integer node ID that can round-trip its external string format."""

    def __new__(cls, value: object) -> "BaseNodeId":
        return int.__new__(cls, _parse_stitch(value))

    @classmethod
    def from_external(cls, value: object) -> "BaseNodeId":
        return cls(value)

    def to_external(self) -> str:
        return str(int(self))


class ProteinId(BaseNodeId):
    """Entrez gene IDs — plain integers externally."""


class DrugId(BaseNodeId):
    """STITCH chemical IDs: 'CID' followed by 9 zero-padded digits."""

    def to_external(self) -> str:
        return "CID" + str(int(self)).zfill(9)


class SideEffectId(BaseNodeId):
    """UMLS concept IDs: 'C' followed by 7 zero-padded digits."""

    def to_external(self) -> str:
        return "C" + str(int(self)).zfill(7)
