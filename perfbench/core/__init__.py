"""The harness: cells, weights, the timed windows, tracing and the check."""
