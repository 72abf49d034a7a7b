"""Host-side utilities: a YAML-subset reader, event logs, console logging."""
