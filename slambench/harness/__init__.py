"""The harness: cells, traffic, device rendering, spans, traces, the
comparison that decides `correct`. Each configuration, traffic mix and
per-layer metric is a file of its own, found by its name."""
