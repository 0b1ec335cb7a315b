"""Host-side utilities of the port (splits, metrics, profiling)."""
