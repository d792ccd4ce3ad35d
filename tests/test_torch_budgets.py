"""The port's budget manifest (repro_torch.analysis.program):

* the committed ``analysis/budgets/cpu_reduced.json`` matches the reduced
  audit on the CPU with no failure;
* ``check_budgets`` flags a drifted key, a new program, a vanished program
  and a changed kernel launch count, and the manifest's tolerances
  override the defaults;
* a save / load round trip leaves the manifest unchanged;
* parity: the reference's ``repro.analysis.program.check_budgets`` and the
  port's give the same failure strings for the same port facts and a
  manifest of the keys both budget;
* the ``program`` CLI diffs against the default manifest, a ``--budgets``
  path, or refreshes it (the audit stubbed with the module's facts).
"""
import copy
import dataclasses
import json

import pytest
import torch

from repro.analysis import program as jprog
from repro_torch.analysis import program as tprog


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def facts():
    return tprog.run_audit(tprog.enumerate_specs(device="cpu"))


def test_committed_cpu_manifest_matches_audit(facts):
    manifest = tprog.load_budgets(tprog.CPU_REDUCED_BUDGETS)
    assert manifest is not None
    assert tprog.check_budgets(facts, manifest) == []
    meta = manifest["_meta"]
    assert meta["device"] == "cpu"
    assert meta["tolerances"] == tprog.BUDGET_TOLERANCES
    assert "--update-budgets" in meta["refresh"]
    assert set(manifest["programs"]) == set(facts)
    row = next(iter(manifest["programs"].values()))
    assert set(row) == set(tprog.BUDGET_KEYS)
    assert "hbm_bytes" not in tprog.BUDGET_KEYS


def test_default_manifest_paths():
    assert tprog.default_budgets_path("cpu", True) == tprog.CPU_REDUCED_BUDGETS
    assert tprog.default_budgets_path("cuda", False) \
        == tprog.H100_FULL_WIDTH_BUDGETS
    assert tprog.default_budgets_path("cpu", False) is None
    assert tprog.default_budgets_path("cuda:0", True) is None


def _launches(f, **k):
    return dataclasses.replace(f, kernel_launches=k)


@pytest.mark.parametrize("case", ["drift", "new", "vanished", "launches",
                                  "launch_gone", "launch_new"])
def test_check_budgets_flags(facts, case):
    facts = dict(facts)
    name = "dense/fl_step_masked/cut1"
    facts[name] = _launches(facts[name], flash_attention=8, masked_update=4)
    manifest = tprog.budgets_from_facts(facts)
    assert tprog.check_budgets(facts, manifest) == []
    if case == "drift":
        manifest["programs"][name]["flops"] *= 1.2
        want = f"{name}: flops drifted"
    elif case == "new":
        del manifest["programs"][name]
        want = f"{name}: audited but missing from manifest"
    elif case == "vanished":
        manifest["programs"]["dense/ghost"] = dict(
            manifest["programs"][name])
        want = "dense/ghost: in manifest but no longer audited"
    elif case == "launches":
        manifest["programs"][name]["kernel_launches"]["flash_attention"] = 9
        want = f"{name}: kernel_launches[flash_attention] drifted"
    elif case == "launch_gone":
        facts[name] = _launches(facts[name], flash_attention=8)
        want = f"{name}: kernel_launches[masked_update] drifted"
    else:
        facts[name] = _launches(facts[name], flash_attention=8,
                                masked_update=4, ssd_scan=1)
        want = f"{name}: kernel_launches[ssd_scan] drifted"
    failures = tprog.check_budgets(facts, manifest)
    assert len(failures) == 1 and failures[0].startswith(want), failures


def test_check_budgets_tolerances(facts):
    manifest = tprog.budgets_from_facts(facts)
    name = "ssm/probe"
    manifest["programs"][name]["flops"] *= 1.05      # inside the 10% default
    assert tprog.check_budgets(facts, manifest) == []
    manifest["_meta"]["tolerances"]["flops"] = 0.01
    failures = tprog.check_budgets(facts, manifest)
    assert len(failures) == 1 and failures[0].startswith(f"{name}: flops")
    # relative to max(|budget|, 1): a 0 budget holds the value within the
    # tolerance itself
    manifest = tprog.budgets_from_facts(facts)
    name = "dense/serve_write_params"
    assert manifest["programs"][name]["flops"] == 0
    f = dict(facts)
    f[name] = dataclasses.replace(facts[name], flops=0.05)
    assert tprog.check_budgets(f, manifest) == []
    f[name] = dataclasses.replace(facts[name], flops=1.0)
    assert len(tprog.check_budgets(f, manifest)) == 1


def test_save_load_round_trip(facts, tmp_path):
    path = tmp_path / "sub" / "budgets.json"
    saved = tprog.save_budgets(facts, str(path))
    loaded = tprog.load_budgets(str(path))
    assert loaded == json.loads(json.dumps(saved))
    assert tprog.check_budgets(facts, loaded) == []
    tprog.save_budgets(facts, str(path))
    assert tprog.load_budgets(str(path)) == loaded
    assert tprog.load_budgets(str(tmp_path / "missing.json")) is None


def test_check_budgets_parity_with_reference(facts):
    shared = ("flops", "weight_bytes", "arg_bytes", "temp_bytes")
    manifest = {"programs": {
        n: {k: getattr(f, k) for k in shared} for n, f in facts.items()}}
    progs = manifest["programs"]
    progs["dense/fl_step"]["flops"] *= 2
    progs["dense/probe"]["weight_bytes"] *= 0.8
    progs["ssm/fl_step"]["arg_bytes"] *= 1.5
    progs["ssm/probe"]["temp_bytes"] = 10
    progs["dense_bf16/serve_decode/B3"]["flops"] *= 1.05     # inside
    del progs["dense/serve_decode/B6"]
    progs["ssm/ghost"] = dict(progs["ssm/fl_step"])
    ours = tprog.check_budgets(facts, copy.deepcopy(manifest))
    ref = jprog.check_budgets(facts, copy.deepcopy(manifest))
    assert ours == ref
    assert len(ours) == 6


# -- the program CLI ---------------------------------------------------------

@pytest.fixture
def cli(facts, monkeypatch):
    """``program_main`` with the audit stubbed by the module's facts."""
    from repro_torch.analysis.__main__ import main
    monkeypatch.setattr(tprog, "audit_models",
                        lambda device, reduced=True: [])
    monkeypatch.setattr(tprog, "enumerate_specs", lambda models: [])
    monkeypatch.setattr(tprog, "run_audit",
                        lambda specs, progress=None: dict(facts))
    return main


def test_cli_default_manifest(cli, capsys):
    assert cli(["program", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "0 budget failure(s)" in err


def test_cli_budget_failure_and_json(cli, facts, tmp_path, capsys):
    bad = tprog.budgets_from_facts(facts)
    bad["programs"]["dense/fl_step"]["flops"] *= 2
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    assert cli(["program", "--device", "cpu", "--budgets", str(path)]) == 1
    assert "BUDGET dense/fl_step: flops drifted" in capsys.readouterr().out
    assert cli(["program", "--device", "cpu", "--budgets", str(path),
                "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert not report["ok"] and len(report["budget_failures"]) == 1


def test_cli_update_and_missing_manifest(cli, facts, tmp_path, capsys):
    path = tmp_path / "new.json"
    assert cli(["program", "--device", "cpu", "--budgets", str(path),
                "--update-budgets"]) == 0
    assert tprog.check_budgets(facts, tprog.load_budgets(str(path))) == []
    capsys.readouterr()
    # a pairing without a committed manifest checks contracts only
    assert cli(["program", "--device", "cpu", "--full-width"]) == 0
    assert "checking contracts only" in capsys.readouterr().err
