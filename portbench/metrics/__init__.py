"""One reader a metric, named after it: ``read(cell)`` returns the
metric's value from what the run recorded, or None where it finds
nothing to read (the metric is then left out of the result)."""
