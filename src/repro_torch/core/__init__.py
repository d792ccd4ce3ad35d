"""Host-side FL core pieces the serving slice needs (counterpart of ``repro/core``)."""
