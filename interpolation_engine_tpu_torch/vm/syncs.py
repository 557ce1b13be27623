"""The general step's host syncs.

Every call on the general step's path that makes the host wait for the
device (a ``nonzero``, a count read back, the distinct pcs read back) goes
through ``host_sync``, so that the recorder in ``core/events.py`` counts
each one (``general.host_syncs``) and times it (span ``general.sync``).
With nothing recording, it costs one attribute test.
"""

from __future__ import annotations

from ..core.events import EVENTS

SPAN = "general.sync"
COUNTER = "general.host_syncs"


def host_sync(fn, *args, **kw):
    """``fn(*args, **kw)``, a call that waits for the device's queue."""
    if EVENTS.recorded is None:
        return fn(*args, **kw)
    EVENTS.count(COUNTER)
    with EVENTS.span(SPAN):
        return fn(*args, **kw)
