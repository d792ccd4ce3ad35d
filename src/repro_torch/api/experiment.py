"""Experiment: the front door of the federation API (counterpart of
``repro/api/experiment.py``).

    from repro_torch.api.experiment import Experiment

    exp = Experiment(model_cfg, task, strategy="ours", cohort_size=8,
                     rounds=20, budget=2, pipeline=False, device="cuda")
    params, history = exp.run(verbose=True)

``Experiment`` wires a model (ArchConfig or a built Model), a
:class:`repro_torch.api.task.Task` and a strategy (registered name or
Strategy instance) into an :class:`FLServer`.  FL hyper-parameters come
from ``fl=FLConfig(...)`` or keyword overrides; ``n_clients`` follows the
task.  The model runs on ``device`` (the card unless ``device="cpu"``).

Not ported yet (ROADMAP.md, 'Slice 5'): pretraining
(``pretrain_steps > 0`` raises), and what the server does not port
(``pipeline=True``, ``checkpoint_dir``, ``faults`` raise there).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Union

import numpy as np

from repro_torch.api.strategy import Strategy, get_strategy
from repro_torch.api.task import Task
from repro_torch.configs.base import ArchConfig, FLConfig, RuntimeConfig
from repro_torch.core.server import FLServer, History
from repro_torch.models.model import Model


class Experiment:
    """One federated fine-tuning run assembled over the pluggable API."""

    def __init__(self, model: Union[ArchConfig, Model], task: Task,
                 strategy: Union[str, Strategy] = "ours", *,
                 fl: Optional[FLConfig] = None,
                 runtime: Optional[RuntimeConfig] = None,
                 engine: str = "vectorized",
                 pipeline: Optional[bool] = None,
                 mask_aware: Optional[bool] = None,
                 checkpoint_dir: Optional[str] = None,
                 faults: Optional[object] = None,
                 pretrain_steps: int = 0,
                 device="cuda",
                 **fl_overrides):
        if pretrain_steps > 0:
            raise NotImplementedError(
                "pretraining (data/pretrain.py, optim/optimizers.py) is not "
                "ported yet (ROADMAP.md, 'Slice 5', item 2)")
        if isinstance(model, Model):
            self.model = model
        else:
            self.model = Model(model, runtime
                               or RuntimeConfig(remat=False, seq_chunk=32),
                               device=device)
        self.task = task
        self.strategy = get_strategy(strategy)
        n_clients = len(np.asarray(task.sizes))
        fl = fl if fl is not None else FLConfig()
        changes = dict(fl_overrides, n_clients=n_clients)
        # keep the record string in sync with the resolved strategy object
        changes["strategy"] = self.strategy.name
        self.fl = replace(fl, **changes)
        if self.fl.cohort_size > n_clients:
            self.fl = replace(self.fl, cohort_size=n_clients)
        self.engine = engine
        self.pipeline = pipeline
        self.mask_aware = mask_aware
        self.checkpoint_dir = checkpoint_dir
        self.faults = faults
        self._server: Optional[FLServer] = None

    def build(self) -> FLServer:
        """Construct (once) and return the round engine."""
        if self._server is None:
            self._server = FLServer(self.model, self.fl, self.task,
                                    engine=self.engine,
                                    pipeline=self.pipeline,
                                    strategy=self.strategy,
                                    mask_aware=self.mask_aware,
                                    checkpoint_dir=self.checkpoint_dir,
                                    faults=self.faults)
        return self._server

    @property
    def server(self) -> FLServer:
        return self.build()

    def init_params(self) -> dict:
        """Fresh params from ``fl.seed`` on the model's device."""
        return self.model.init(self.fl.seed)

    def run(self, params: Optional[dict] = None,
            rounds: Optional[int] = None,
            verbose: bool = False) -> tuple[dict, History]:
        """Run Algorithm 1 for ``rounds`` (default ``fl.rounds``)."""
        server = self.build()
        if params is None:
            params = self.init_params()
        return server.run(params, rounds=rounds, verbose=verbose)
