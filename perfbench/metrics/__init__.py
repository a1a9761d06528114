"""One reader a metric: ``metrics/<name>.py`` has ``read(ctx)``, which
returns the metric's value from the run's context, or None where it finds
nothing to read (the harness then leaves the metric out)."""
