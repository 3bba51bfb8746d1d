"""One reader a per-layer metric, ``<name>.py`` with ``read(window)``
returning the value, or None where the traced window holds nothing for
it to read (the harness then leaves the metric out)."""
