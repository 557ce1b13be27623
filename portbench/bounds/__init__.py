"""The least time of each kernel a roofline metric names, one module a
kernel, found by the ``bound`` of its ``metrics/*.json``; and the table of
peaks they divide by (``peaks.json``)."""
