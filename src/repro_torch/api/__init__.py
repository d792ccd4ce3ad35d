"""The federation API: strategy registry, Task protocol, Experiment
(counterpart of ``repro/api``).

``Experiment`` is imported lazily (PEP 562), as in the reference:
``core.server`` imports the strategy registry at module level and
``experiment`` imports the server back.
"""
from repro_torch.api.strategy import (PROBE_KEYS,  # noqa: F401
                                      MixtureStrategy, ProbeReport,
                                      ScoreStrategy, SelectionContext,
                                      Strategy, UnknownStrategyError,
                                      get_strategy, register_strategy,
                                      strategy_names)
from repro_torch.api.task import (ChaosTask, DirichletTaskConfig,  # noqa: F401
                                  DirichletTokenMixtureTask, Task)

__all__ = [
    "PROBE_KEYS", "ProbeReport", "SelectionContext", "Strategy",
    "ScoreStrategy", "MixtureStrategy", "UnknownStrategyError",
    "register_strategy", "get_strategy", "strategy_names",
    "Task", "ChaosTask", "DirichletTaskConfig", "DirichletTokenMixtureTask",
    "Experiment",
]


def __getattr__(name):
    if name == "Experiment":
        from repro_torch.api.experiment import Experiment
        return Experiment
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
