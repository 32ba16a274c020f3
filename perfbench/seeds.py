"""Seeds of a run's draws, derived from ``--seed`` and a name for each draw."""
from __future__ import annotations

import hashlib


def derive(seed, *tags):
    """A 63-bit seed for the draw named by ``tags`` in the run of ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1
