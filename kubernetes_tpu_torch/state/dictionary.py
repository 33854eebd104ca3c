"""String interning: host strings ↔ int32 ids for device tensor programs.

Every string the device path compares (label keys/values, taint keys/values,
namespaces, node names, image names, topology values, resource names) is interned
once host-side; device programs only see int32 ids. A parallel float32 side-table
holds the numeric value of ids whose string parses as an integer, enabling the
NodeSelector Gt/Lt operators as tensor compares.

Id space: ids start at 0; -1 is the universal "absent / padding" sentinel in all
encoded arrays (never a valid id).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

MISSING = -1

# Well-known strings interned at Dictionary construction so their ids are
# compile-time constants usable inside jitted plugin programs.
WELL_KNOWN = (
    "",
    "metadata.name",
    "kubernetes.io/hostname",
    "node.kubernetes.io/unschedulable",
    "topology.kubernetes.io/zone",
    "topology.kubernetes.io/region",
    "0.0.0.0",
)
ID_EMPTY = 0
ID_META_NAME = 1
ID_HOSTNAME = 2
ID_UNSCHEDULABLE_TAINT = 3
ID_ZONE = 4
ID_REGION = 5
ID_WILDCARD_IP = 6  # HostPortInfo DefaultBindAllHostIP (framework/types.go)

_INT_RE = __import__("re").compile(r"^[+-]?[0-9]+$")
_INT64_MAX = 2**63 - 1


def _parse_numeric(s: str) -> float:
    """Numeric side-table semantics = Go strconv.Atoi (the reference parses
    Gt/Lt operands with it, nodeaffinity): ASCII digits with optional sign,
    no underscores/whitespace, int64 range.  Keeps PyDictionary and the C++
    interner (strtoll with the same checks) bit-identical across hosts."""
    if not _INT_RE.match(s):
        return math.nan
    v = int(s)
    if v > _INT64_MAX or v < -_INT64_MAX - 1:
        return math.nan
    return float(v)


class PyDictionary:
    """Append-only string interner. Thread-compatible with the scheduler's single
    event-ingest thread (mirrors the single-writer discipline of the reference's
    scheduler cache, internal/cache/cache.go:62)."""

    def __init__(self):
        self._to_id: Dict[str, int] = {}
        self._to_str: List[str] = []
        self._numeric: List[float] = []
        for s in WELL_KNOWN:
            self.intern(s)

    def __len__(self) -> int:
        return len(self._to_str)

    def intern(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is not None:
            return i
        i = len(self._to_str)
        self._to_id[s] = i
        self._to_str.append(s)
        self._numeric.append(_parse_numeric(s))
        return i

    def lookup(self, s: str) -> int:
        """Id of s, or MISSING if never interned (read-only: does not grow)."""
        return self._to_id.get(s, MISSING)

    def intern_many(self, strings) -> List[int]:
        return [self.intern(s) for s in strings]

    def string(self, i: int) -> str:
        return self._to_str[i]

    def numeric_table(self, min_size: int = 1) -> np.ndarray:
        """float32[num_ids] — numeric value per id (NaN when non-integer)."""
        n = max(len(self._numeric), min_size)
        t = np.full((n,), np.nan, dtype=np.float32)
        if self._numeric:
            t[: len(self._numeric)] = np.asarray(self._numeric, dtype=np.float32)
        return t


def Dictionary():
    """Build an interner: the Python dict interner (the only one the port
    keeps)."""
    return PyDictionary()
