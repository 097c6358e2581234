"""One reader per metric, ``read(ctx)``, found by the metric's name."""
