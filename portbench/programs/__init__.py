"""Frozen copies of the program generators the traffic mixes name.

A traffic file's ``"program"`` names a module here, whose ``source(**params)``
returns the program's JSON5 text. The copies are frozen so that
an edit to the port's own generators cannot change what the benchmark runs.
"""
