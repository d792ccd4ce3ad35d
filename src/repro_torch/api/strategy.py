"""Strategy protocol + registry: layer selection as a pluggable primitive
(counterpart of ``repro/api/strategy.py``; ``score_device`` is torch).

The paper's central lever is the *layer selection strategy*; here it is a
first-class component instead of a string ``if/elif``.  A strategy is an
object with three declarations the round engines consume:

* ``probe_requirements`` — which probe statistics it needs
  (subset of :data:`PROBE_KEYS`).  ``Client.probe_cohort`` computes *only*
  the requested stats, so e.g. ``ours`` pays for gradient square norms only
  while ``snr`` pays for mean/var — not every strategy pays for everything.
* ``host`` — True for strategies whose selection is a host-side solve
  (``ours``/``unified`` run the (P1) solver on L floats per client); False
  for score-based strategies, which additionally expose a device-side
  :meth:`ScoreStrategy.score_device` (torch ops on the probe's stat
  tensors) so the per-layer score is computed where the stats are (the
  mask top-k itself stays on the host — it is O(n·L) on tiny arrays).
* ``select(probe, budgets, ctx)`` — the (cohort, L) mask matrix.

Strategies register by name::

    @register_strategy("my_strategy")
    class MyStrategy(Strategy):
        probe_requirements = frozenset({"grad_sq_norms"})
        def select(self, probe, budgets, ctx): ...

and are resolved with :func:`get_strategy`, which accepts either a name or
a ``Strategy`` instance and raises :class:`UnknownStrategyError` (with the
registered names and a nearest-match suggestion) for unknown names.

:class:`MixtureStrategy` is the per-client heterogeneous meta-strategy:
it maps client ids to registered strategies, requests the union of their
probe requirements, and routes each cohort row to its owner's ``select``.
"""
from __future__ import annotations

import difflib
from dataclasses import dataclass, replace
from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.core.solver import get_solver
from repro_torch.core.strategies import (PROBE_KEYS, ProbeReport, _positional,
                                         _score_topk)

StrategyLike = Union[str, "Strategy"]


class UnknownStrategyError(KeyError, ValueError):
    """Unknown strategy name.  Subclasses both KeyError and ValueError so
    pre-registry callers catching either keep working."""

    def __init__(self, name: str, registered: tuple[str, ...]):
        self.name = name
        self.registered = registered
        close = difflib.get_close_matches(str(name), registered, n=1,
                                          cutoff=0.4)
        hint = f" — did you mean {close[0]!r}?" if close else ""
        super().__init__(
            f"unknown strategy {name!r}{hint} "
            f"(registered: {', '.join(registered)})")

    def __str__(self) -> str:      # KeyError would repr() the message
        return self.args[0]


@dataclass(frozen=True)
class SelectionContext:
    """Host-side context the engines hand to ``Strategy.select``."""

    client_ids: np.ndarray                 # (n,) cohort client ids
    round: int = 0
    lam: float = 10.0                      # λ in (P1)
    costs: Optional[np.ndarray] = None     # (L,) per-layer cost vector
    n_layers: int = 0
    eps: float = 1e-12
    # warm-start hint for iterative host solvers: the cohort's previous
    # converged mask rows (aligned with client_ids), or None for a cold
    # start.  FLServer fills this from its per-client-id mask cache; a
    # strategy is free to ignore it.
    init: Optional[np.ndarray] = None      # (n, L) previous masks


class Strategy:
    """Base class for layer-selection strategies."""

    name: str = "?"
    probe_requirements: frozenset = frozenset()
    host: bool = False
    # True => select() is a pure function of (probe, budgets, client_ids,
    # lam, costs) — notably independent of ctx.round — so the round engines
    # may skip the solve when those inputs are byte-identical to the
    # previous round ("unchanged utilities" early exit).  Leave False for
    # strategies with round-dependent schedules (exploration, annealing).
    memoizable_select: bool = False

    def select(self, probe: ProbeReport, budgets,
               ctx: SelectionContext) -> np.ndarray:
        """Return the (cohort, L) float32 mask matrix."""
        raise NotImplementedError

    def device_score_fn(self) -> Optional[Callable]:
        """A torch stats-dict → (n, L) scores callable for the vectorized
        probe to apply on the device, or None (host/positional
        strategies)."""
        return None

    def __repr__(self) -> str:
        return f"<Strategy {self.name}>"


class ScoreStrategy(Strategy):
    """Strategies that rank layers by a per-layer score.

    Subclasses implement :meth:`score_device` with torch ops over the
    requested stats; the same formula serves both paths: on the device
    inside the vectorized probe (``probe.scores``), or on the host from the
    uploaded stats (the sequential oracle and the ``select()`` shim).
    """

    def score_device(self, stats: dict, eps: float = 1e-12):
        raise NotImplementedError

    def device_score_fn(self) -> Callable:
        return self.score_device

    def select(self, probe: ProbeReport, budgets,
               ctx: SelectionContext) -> np.ndarray:
        scores = probe.scores
        if scores is None:
            stats = {k: torch.as_tensor(getattr(probe, k)) for k in PROBE_KEYS
                     if getattr(probe, k) is not None}
            scores = self.score_device(stats, eps=ctx.eps).numpy()
        return _score_topk(np.asarray(scores), budgets)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Strategy] = {}


def register_strategy(name: str, *, aliases: Iterable[str] = ()):
    """Class/instance decorator: register under ``name`` (+ aliases)."""

    def deco(obj):
        inst = obj() if isinstance(obj, type) else obj
        inst.name = name
        _REGISTRY[name] = inst
        for a in aliases:
            _REGISTRY[a] = inst
        return obj

    return deco


def strategy_names() -> tuple[str, ...]:
    """All registered names (canonical names and aliases), sorted."""
    return tuple(sorted(_REGISTRY))


def get_strategy(strategy: StrategyLike) -> Strategy:
    """Resolve a name (or pass through an instance) to a Strategy."""
    if isinstance(strategy, Strategy):
        return strategy
    try:
        return _REGISTRY[strategy]
    except KeyError:
        raise UnknownStrategyError(strategy, strategy_names()) from None


# ---------------------------------------------------------------------------
# Built-in strategies (the paper's §5.1 baselines + ours)
# ---------------------------------------------------------------------------

class _Positional(Strategy):
    """No probe needed: masks depend only on position and budget."""

    def __init__(self, mode: str):
        self._mode = mode

    def select(self, probe, budgets, ctx):
        return _positional(probe.n, probe.L, budgets, self._mode)


register_strategy("top")(_Positional("top"))
register_strategy("bottom")(_Positional("bottom"))
register_strategy("both")(_Positional("both"))


@register_strategy("full")
class _Full(Strategy):
    def select(self, probe, budgets, ctx):
        return np.ones((probe.n, probe.L), np.float32)


@register_strategy("snr")
class _SNR(ScoreStrategy):
    """Highest |mean(g)| / var(g) per layer [Mahsereci+17]."""

    probe_requirements = frozenset({"grad_means", "grad_vars"})

    def score_device(self, stats, eps: float = 1e-12):
        return torch.abs(stats["grad_means"]) / (stats["grad_vars"] + eps)


@register_strategy("rgn")
class _RGN(ScoreStrategy):
    """Highest ‖g_l‖ / ‖θ_l‖ (relative gradient norm) [Lee+22]."""

    probe_requirements = frozenset({"grad_sq_norms", "param_sq_norms"})

    def score_device(self, stats, eps: float = 1e-12):
        return (torch.sqrt(stats["grad_sq_norms"])
                / (torch.sqrt(stats["param_sq_norms"]) + eps))


@register_strategy("gradnorm")
class _GradNorm(ScoreStrategy):
    """Highest raw ‖g_l‖² — the λ=0 limit of (P1), useful as a mixture
    member and as the cheapest probe-based baseline."""

    probe_requirements = frozenset({"grad_sq_norms"})

    def score_device(self, stats, eps: float = 1e-12):
        return stats["grad_sq_norms"]


class _OursSolver(Strategy):
    """(P1) host solver — λ consistency-regularised selection (§4.2)."""

    host = True
    probe_requirements = frozenset({"grad_sq_norms"})
    memoizable_select = True          # (P1) is round-independent

    def __init__(self, solver: str):
        self._solver = solver

    def select(self, probe, budgets, ctx):
        solve = get_solver(self._solver)
        if self._solver == "icm":
            # ctx.init warm-starts the block-coordinate ascent from the
            # cohort's previous converged masks — fewer sweeps once layer
            # utilities stabilise, still budget-exact (core/solver.py)
            masks, _, _ = solve(probe.grad_sq_norms, budgets, ctx.lam,
                                costs=ctx.costs, init=ctx.init)
            return masks
        return solve(probe.grad_sq_norms, budgets, costs=ctx.costs)


register_strategy("ours")(_OursSolver("icm"))
register_strategy("ours_unified", aliases=("unified",))(
    _OursSolver("unified"))


# ---------------------------------------------------------------------------
# Per-client heterogeneous mixtures
# ---------------------------------------------------------------------------

class MixtureStrategy(Strategy):
    """Meta-strategy: client ids → registered strategies.

    ``assignment`` is a ``{client_id: strategy}`` dict or a
    ``client_id -> strategy`` callable (values are names or instances);
    unmapped clients fall back to ``default``.  With a callable assignment,
    pass ``members`` so the probe requirements (the union over all member
    strategies) are known up front.  Device score fusion is disabled —
    each member scores its own rows from the uploaded stats.

    Selection runs each member strategy on *its own client rows*: joint
    solvers like ``ours`` couple clients within their group via λ (their
    consistency regulariser sees only same-strategy cohort members), while
    score/positional members are row-independent anyway.
    """

    name = "mixture"

    def __init__(self, assignment, default: StrategyLike = "ours", *,
                 members: Iterable[StrategyLike] = ()):
        self._default = get_strategy(default)
        if callable(assignment):
            self._fn = assignment
            declared = list(members)
            if not declared:
                raise ValueError(
                    "MixtureStrategy with a callable assignment needs "
                    "members=[...] to declare its probe requirements")
        else:
            mapping = {int(k): get_strategy(v) for k, v in assignment.items()}
            self._fn = mapping.get
            declared = list(mapping.values())
        self._members = tuple(dict.fromkeys(            # order-stable unique
            [get_strategy(m) for m in declared] + [self._default]))
        self.probe_requirements = frozenset().union(
            *(m.probe_requirements for m in self._members))
        self.host = any(m.host for m in self._members)
        # routing is by client id (in the memo key), so the mixture is
        # memoizable iff every member is
        self.memoizable_select = all(
            getattr(m, "memoizable_select", False) for m in self._members)

    def strategy_of(self, client_id: int) -> Strategy:
        s = self._fn(int(client_id))
        return self._default if s is None else get_strategy(s)

    def select(self, probe, budgets, ctx):
        ids = np.asarray(ctx.client_ids)
        n, L = probe.n, probe.L
        budgets = np.broadcast_to(np.asarray(budgets, int), (n,))
        owners = [self.strategy_of(i) for i in ids]
        masks = np.zeros((n, L), np.float32)
        for strat in dict.fromkeys(owners):
            rows = np.array([r for r, o in enumerate(owners) if o is strat])
            sub = replace(ctx, client_ids=ids[rows],
                          init=None if ctx.init is None else ctx.init[rows])
            masks[rows] = strat.select(probe.take(rows), budgets[rows], sub)
        return masks


__all__ = [
    "PROBE_KEYS", "ProbeReport", "SelectionContext", "Strategy",
    "ScoreStrategy", "MixtureStrategy", "UnknownStrategyError",
    "register_strategy", "get_strategy", "strategy_names",
]
