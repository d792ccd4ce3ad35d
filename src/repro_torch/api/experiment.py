"""Experiment: the front door of the federation API (counterpart of
``repro/api/experiment.py``).

    from repro_torch.api.experiment import Experiment

    exp = Experiment(model_cfg, task, strategy="ours", cohort_size=8,
                     rounds=20, budget=2, pretrain_steps=150,
                     checkpoint_dir="ckpt", device="cuda")
    params, history = exp.run(verbose=True)

``Experiment`` wires a model (ArchConfig or a built Model), a
:class:`repro_torch.api.task.Task` and a strategy (registered name or
Strategy instance) into an :class:`FLServer`.  FL hyper-parameters come
from ``fl=FLConfig(...)`` or keyword overrides (``seed`` sets
``fl.seed``); ``n_clients`` follows the task.  The vectorized engine
streams through the round scheduler (``pipeline_depth`` rounds ahead)
unless ``pipeline=False``; ``pretrain_steps > 0`` pretrains the initial
params with AdamW on the task's ``pretrain_batch`` (``data/pretrain.py``);
``checkpoint_dir`` saves round-boundary checkpoints and ``run`` resumes
from the latest one; ``faults`` (a ``repro_torch.faults.FaultPlan`` or
``FaultInjector``) injects client death, delta corruption, solver stalls,
dispatch failures and checkpoint damage, and ``solver_deadline_s`` puts a
wall-clock deadline on the scheduler's (P1) solve (DESIGN.md §12).  The
model runs on ``device`` (the card unless ``device="cpu"``).
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
                 pipeline_depth: int = 1,
                 mask_aware: Optional[bool] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 10,
                 faults: Optional[object] = None,
                 solver_deadline_s: Optional[float] = None,
                 pretrain_steps: int = 0, pretrain_lr: float = 3e-3,
                 seed: Optional[int] = None,
                 device="cuda",
                 **fl_overrides):
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
        if seed is not None:
            changes["seed"] = seed
        # keep the record string in sync with the resolved strategy object
        changes["strategy"] = self.strategy.name
        self.fl = replace(fl, **changes)
        if self.fl.cohort_size > n_clients:
            self.fl = replace(self.fl, cohort_size=n_clients)
        self.engine = engine
        self.pipeline = pipeline
        self.pipeline_depth = pipeline_depth
        self.mask_aware = mask_aware
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.faults = faults
        self.solver_deadline_s = solver_deadline_s
        self.pretrain_steps = pretrain_steps
        self.pretrain_lr = pretrain_lr
        self._server: Optional[FLServer] = None

    def build(self) -> FLServer:
        """Construct (once) and return the round engine."""
        if self._server is None:
            self._server = FLServer(self.model, self.fl, self.task,
                                    engine=self.engine,
                                    pipeline=self.pipeline,
                                    pipeline_depth=self.pipeline_depth,
                                    strategy=self.strategy,
                                    mask_aware=self.mask_aware,
                                    checkpoint_dir=self.checkpoint_dir,
                                    checkpoint_every=self.checkpoint_every,
                                    faults=self.faults,
                                    solver_deadline_s=self.solver_deadline_s)
        return self._server

    @property
    def server(self) -> FLServer:
        return self.build()

    def init_params(self) -> dict:
        """Fresh params from ``fl.seed`` on the model's device, pretrained
        when ``pretrain_steps > 0`` (the task must have
        ``pretrain_batch``)."""
        params = self.model.init(self.fl.seed)
        if self.pretrain_steps > 0:
            from repro_torch.data.pretrain import pretrain
            params = pretrain(self.model, params, self.task,
                              steps=self.pretrain_steps, lr=self.pretrain_lr)
        return params

    def run(self, params: Optional[dict] = None,
            rounds: Optional[int] = None,
            verbose: bool = False, resume: bool = True
            ) -> tuple[dict, History]:
        """Run Algorithm 1 for ``rounds`` (default ``fl.rounds``).

        With ``checkpoint_dir`` set, state is saved at round boundaries and
        — unless ``resume=False`` — the latest intact checkpoint there is
        restored first (params, client-state store, rng streams, History),
        without pretraining: the continued run chooses the masks of one
        that never stopped.  A checkpoint at or past ``rounds`` returns the
        restored result."""
        server = self.build()
        start, history = 0, None
        if resume and self.checkpoint_dir is not None:
            restored = server.restore_state(
                params if params is not None
                else self.model.init(self.fl.seed))
            if restored is not None:
                params, start, history = restored
        if params is None:
            params = self.init_params()
        return server.run(params, rounds=rounds, verbose=verbose,
                          start=start, history=history)
