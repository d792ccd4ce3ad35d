"""Federated datasets (counterpart of ``repro/data``)."""
