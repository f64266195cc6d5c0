"""One reader per metric, found by the metric's name: `read(ctx)` returns its value or None."""
