"""The FL core: masks, aggregation, clients, (P1) selection, per-client state and the server (counterpart of ``repro/core``)."""
