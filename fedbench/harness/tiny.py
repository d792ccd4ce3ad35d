"""A cell cut to a size the CPU runs in seconds, for the tests and for
rehearsing a run without a card: every width shrunk, the traffic to a few
short sequences.  Never a benchmark cell."""
from __future__ import annotations

from fedbench.harness.manifest import Cell

SHRINK = {"ssm": dict(n_layers=3, d_model=32, ssm_heads=2, ssm_state=8,
                      ssm_chunk=8, vocab_size=128)}


def tiny_cell(name: str) -> Cell:
    cell = Cell(name)
    cell.c.update(SHRINK[cell.family])
    cell.vocab = cell.c["vocab_size"]
    cell.traffic["seq_len"] = 16
    cell.traffic["fl"]["batch_size"] = 2
    cell.traffic["data"].update(test_samples=4, n_clients=8)
    return cell
