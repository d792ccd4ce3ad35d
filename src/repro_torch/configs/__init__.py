"""Per-architecture configs of the port (copies of ``repro/configs``)."""
