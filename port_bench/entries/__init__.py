"""Entries: each module drives one entry point of the port for a cell
and judges what its calls returned with the reference.  A traffic mix
names its entry; :func:`prepare` builds it from the run's context."""
