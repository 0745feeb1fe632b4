"""One reader a metric: ``<base>.py`` holds ``read(rec)``, which returns the
metric's value from a ``record.RunRecord``, or None where it finds nothing
to read. ``<base>`` is the metric's name before its first dot."""
