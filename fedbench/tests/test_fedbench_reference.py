"""The plain reference against the program (``repro_torch``) at a reduced
size on the CPU, in float32: the loss and every selectable leaf row's
gradient, for each family the benchmark runs, and one reference round
against the program's round step."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from fedbench.harness.tiny import tiny_cell
from fedbench.harness.weights import flat_rows, make_params
from fedbench.reference.numerics import Numerics
from fedbench.reference.rounds import Federation
from repro_torch.configs.base import ArchConfig, RuntimeConfig  # noqa: E402
from repro_torch.core.client import Client  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

CELLS = ("mamba2-370m.round.ours",)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one thread each, so that test workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(name, seed=5):
    cell = tiny_cell(name)
    c = dict(cell.c, dtype="float32")
    model = Model(ArchConfig(**c), RuntimeConfig(remat=False, seq_chunk=32),
                  device="cpu")
    params = make_params(cell.reference.leaf_specs(c), seed, "cpu",
                         dtype=torch.float32)
    gen = np.random.RandomState(seed)
    tokens = torch.from_numpy(gen.randint(0, c["vocab_size"], (2, 16))
                              .astype(np.int32))
    return cell, c, model, params, tokens


@pytest.mark.parametrize("name", CELLS)
def test_loss_and_every_gradient_match_the_program(name):
    cell, c, model, params, tokens = setup(name)
    paths = [p for p in ("blocks", "shared_attn") if p in params]
    wrt = {p: {k: v.detach().clone().requires_grad_()
               for k, v in params[p].items()} for p in paths}
    loss = model.seq_loss({**params, **wrt}, {"tokens": tokens})
    leaves = [v for p in paths for v in wrt[p].values()]
    grads = dict(zip([(p, k) for p in paths for k in wrt[p]],
                     torch.autograd.grad(loss, leaves)))
    prog = flat_rows({p: {k: grads[(p, k)] for k in wrt[p]} for p in paths})

    units = cell.reference.units(c)
    rloss, rgrad = cell.reference.stack(c, Numerics("f32")).loss(
        flat_rows(params), tokens, c, Numerics("f32"), range(len(units)))
    assert float(rloss) == pytest.approx(float(loss.detach()), rel=1e-5)
    assert set(rgrad) == set(prog)
    for k, g in rgrad.items():
        scale = max(float(g.abs().max()), 1e-8)
        assert float((g - prog[k]).abs().max()) / scale < 1e-4, k


@pytest.mark.parametrize("name", CELLS)
def test_a_reference_round_matches_the_program_round_step(name):
    cell, c, model, params, _ = setup(name, seed=9)
    fl = cell.traffic["fl"]
    rng = np.random.RandomState(3)
    n, tau = 2, fl["local_steps"]
    toks = rng.randint(0, c["vocab_size"], (n, tau, 2, 16)).astype(np.int32)
    L = model.n_selectable
    masks = np.zeros((n, L), np.float32)
    masks[0, [1, L - 1]] = 1
    masks[1, [L - 1]] = 1
    sizes = np.array([30.0, 50.0])
    new, losses = Client(model).cohort_update_raw(
        params, {"tokens": torch.from_numpy(toks)}, masks, sizes, fl["lr"])
    fed = Federation(cell.reference, c, flat_rows(params), fl,
                     Numerics("f32"))
    rlosses, _ = fed.round(torch.from_numpy(toks), masks, sizes)
    np.testing.assert_allclose(rlosses, losses.detach().numpy(), rtol=1e-5)
    got = flat_rows(new)
    for k, t in fed.state.items():
        np.testing.assert_allclose(t.numpy(), got[k].detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
