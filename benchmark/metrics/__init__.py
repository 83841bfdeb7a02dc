"""One reader per metric, found by the metric's name: read(m) -> value or None."""
