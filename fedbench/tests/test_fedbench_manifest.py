"""``BENCHMARK.json`` and the files it names keep their format: names and
units in their characters, every per-layer metric moving a rate its
listed cells report, every configuration used, every named file
present."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fedbench"]
    assert BENCH["command"] == ["python3", "fedbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_one_line_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def reported(metric: dict) -> set:
    cells = {w["name"] for w in BENCH["workloads"]}
    return set(metric.get("workloads", cells))


def test_end_to_end_bounds_and_cover():
    by = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(by) == {"train_tok_s", "setup_s"}
    assert by["setup_s"]["bound"] <= 0.25
    for m in by.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert "workloads" not in m


def test_per_layer_metrics_move_a_rate_each_listed_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] == "train_tok_s"
        assert m["source"] in SOURCES
        assert m["workloads"] and set(m["workloads"]) <= reported(
            e2e[m["moves"]])
        assert (ROOT / "fedbench" / "metrics" / f"{m['name']}.py").is_file()


def test_every_config_has_a_cell_and_its_files():
    used = {w["config"] for w in BENCH["workloads"]}
    for conf in BENCH["configs"]:
        assert conf["name"] in used
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["source"] == conf["source"]
        assert conf["file"].startswith("fedbench/")
        for key in conf["reduced"]:
            assert NAME.match(key)
            assert key in data
            assert not key.endswith(("_dim", "_rank"))
        fam = data["family"]
        assert (ROOT / "fedbench" / "reference" / f"{fam}.py").is_file()
        assert (ROOT / "fedbench" / "work" / f"{fam}.py").is_file()


def test_cells_one_chip_and_their_files():
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec = json.loads((ROOT / "fedbench" / "workloads"
                           / f"{w['name']}.json").read_text())
        assert spec["limits"]
        traffic = json.loads((ROOT / "fedbench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert traffic["strategy"] in ("ours", "top")


WIDTH = ("hidden", "intermediate", "latent", "state", "proj", "head",
         "expand", "_dim", "_rank", "experts_per_tok", "d_model", "d_ff")


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_cut_no_width_and_run_the_published_one(conf):
    """``reduced`` names no width; the widths the program runs are the
    file's published ones (Mamba2: the source's ``config.json`` and
    mamba_ssm's Mamba2 defaults, the vocabulary padded as published)."""
    assert not [k for k in conf["reduced"]
                if any(w in k.lower() for w in WIDTH)]
    data = json.loads((ROOT / conf["file"]).read_text())
    run = data["as_run"]
    if conf["name"] == "mamba2-370m":
        ssm = data["assumed"]["ssm_cfg"]
        assert data["ssm_cfg"] == {"layer": "Mamba2"}
        assert (run["n_layers"], run["d_model"]) == (data["n_layer"],
                                                     data["d_model"]) \
            == (48, 1024)
        pad = data["pad_vocab_size_multiple"]
        assert run["vocab_size"] == -(-data["vocab_size"] // pad) * pad \
            == 50288
        assert run["ssm_state"] == ssm["d_state"]
        assert run["ssm_expand"] == ssm["expand"]
        assert run["ssm_conv"] == ssm["d_conv"]
        assert run["ssm_groups"] == ssm["ngroups"]
        assert run["ssm_heads"] * ssm["headdim"] == ssm["expand"] * 1024
