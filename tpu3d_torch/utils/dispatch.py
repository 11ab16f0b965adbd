"""Host-blocking round trips per phase (tpu3d/utils/dispatch.py).

tpu3d counts the round trips to its remote TPU: each dispatch or fetch
that blocks the host. The port counts the same sites, where the host waits
for the card (a copy of a result to the host), under tpu3d's names:
``pnp_chunk``, ``pnp_single``, ``triangulate``, ``local_ba``,
``gba_mask_fetch`` and ``gba_commit`` in the engine, ``extract_batch``,
``extract_bulk_fetch``, ``retrieve``, ``match_block`` and ``match_single``
in the pipeline. ``ba_readback`` is the port's own: each read-back inside
``ba/lm.py``'s solve (the segment widths once per solve, the stop rule
once per LM step), which tpu3d's while loops keep on the device.

Usage: ``tick("phase")`` at each site; ``reset()`` before a measured run
and ``snapshot()`` after it.
"""
from __future__ import annotations

from typing import Dict

COUNTS: Dict[str, int] = {}


def tick(phase: str, n: int = 1) -> None:
    COUNTS[phase] = COUNTS.get(phase, 0) + n


def reset() -> None:
    COUNTS.clear()


def snapshot() -> Dict[str, int]:
    return dict(COUNTS)
