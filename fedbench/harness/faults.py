"""Faults planted in the program's timed path, for the tests that show a
run with a broken program comes out not correct (each takes the
``Experiment`` after it is built and wraps one of its instance's
methods): a round step that returns the weights unchanged, half of every
batch left out (the loss the mean over the rest), one layer's aggregated
update altered (doubled) where it is produced, and the (P1) masks solved
on the probe's utilities in reverse layer order."""
import numpy as np


def frozen(exp):
    client = exp.server.client
    orig = client.cohort_update_raw

    def step(params, *a, **kw):
        return params, orig(params, *a, **kw)[1]
    client.cohort_update_raw = step


def half_batch(exp):
    model = exp.model
    orig = model.seq_loss

    def seq_loss(params, batch, **kw):
        n = next(iter(batch.values())).shape[0]
        return orig(params, {k: v[: max(1, n // 2)] for k, v in
                             batch.items()}, **kw)
    model.seq_loss = seq_loss


def alter(exp):
    client = exp.server.client
    orig = client.cohort_update_raw

    def step(params, batches, masks, *a, **kw):
        new, losses = orig(params, batches, masks, *a, **kw)
        layer = int(np.flatnonzero(np.asarray(masks)[0])[0])
        old, got = params["blocks"]["ssm_in_proj"], new["blocks"]["ssm_in_proj"]
        out = got.clone()
        out[layer] = (old[layer].float() + 2 * (got[layer].float()
                                                - old[layer].float())
                      ).to(got.dtype)
        new = dict(new, blocks=dict(new["blocks"], ssm_in_proj=out))
        return new, losses
    client.cohort_update_raw = step


def reversed_utilities(exp):
    server = exp.server
    orig = server.select_round

    def select_round(plan, stats):
        if stats is not None:
            stats = dict(stats, grad_sq_norms=np.ascontiguousarray(
                np.asarray(stats["grad_sq_norms"])[:, ::-1]))
        return orig(plan, stats)
    server.select_round = select_round


FAULTS = (frozen, half_batch, alter)
# a fault only a cell that solves (P1) can have
SELECTION_FAULTS = (reversed_utilities,)
