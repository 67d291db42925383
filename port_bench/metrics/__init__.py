"""Metric readers: ``<metric name>.py`` holds ``read(rec)``, which takes
the run's record and returns the metric's value, or None where it finds
nothing to read (the metric is then left out of the line)."""
