"""The federation API: strategy registry, Task protocol, Experiment (counterpart of ``repro/api``)."""
