"""Hand-written Hopper kernels of the port.

``LAUNCHES`` counts, per kernel name, the launches each wrapper made; a
wrapper adds one where it launches its kernel and nowhere else, so a run can
show that its path went through the kernels.
"""
from __future__ import annotations

import collections

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
