"""``python -m pinn_torch`` and the port's ``run_campaign``: the
``CAMPAIGN``/``BUDGETS``/``PARITY_NAMES`` tables equal the JAX
``run_campaign``'s, ``--verify``'s lines and exit codes on stubbed recipes,
``--f32``'s stage hp against the JAX campaign's over all eight recipes,
``run --list``, ``run``'s hp layering (defaults, file, ``--set``),
``campaign``'s delegation, ``info`` without a card, and the refusal of
``bench`` (a message and a non-zero exit, no traceback).
"""

import json
import os
import subprocess
import sys

import pytest

from pinn_torch import cli
from pinn_torch.experiments import run_campaign

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXPERIMENTS = ["custom_pde_example", "ide_cont_burgers", "ide_cont_navierstokes", "ide_disc_burgers",
               "ide_disc_kdv", "inf_cont_burgers", "inf_cont_schrodinger",
               "inf_disc_allencahn", "inf_disc_burgers", "serving_example"]


@pytest.fixture(scope="module")
def jax_campaign():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import run_campaign as jax_run_campaign
    return jax_run_campaign


def _module(*args, timeout=120):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, "-m", "pinn_torch", *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=timeout)


@pytest.mark.parametrize("name", ["inf_cont_burgers", "inf_cont_schrodinger",
                                  "ide_cont_burgers", "ide_cont_navierstokes",
                                  "inf_disc_burgers", "ide_disc_burgers",
                                  "inf_disc_allencahn", "ide_disc_kdv"])
def test_campaign_entry_equals_jax(jax_campaign, name):
    assert run_campaign.CAMPAIGN[name] == jax_campaign.CAMPAIGN[name]
    assert run_campaign.BUDGETS[name] == jax_campaign.BUDGETS[name]


def test_campaign_tables_equal_jax(jax_campaign):
    assert list(run_campaign.CAMPAIGN) == list(jax_campaign.CAMPAIGN)
    assert run_campaign.BUDGETS == jax_campaign.BUDGETS
    assert run_campaign.PARITY_NAMES == jax_campaign.PARITY_NAMES
    assert run_campaign.QUICK_OVERRIDES == jax_campaign.QUICK_OVERRIDES


def _stub(monkeypatch, errors, ran):
    """run_recipe replaced: each name's error from ``errors`` (an
    exception raises)."""
    def run_recipe(name, workdir, device=None, quick=False, overrides=None,
                   f32=False):
        ran.append((name, device, quick))
        if isinstance(errors[name], Exception):
            raise errors[name]
        budget = run_campaign.BUDGETS[name]
        return {"experiment": name, "error": errors[name], "budget": budget,
                "met": errors[name] <= budget, "stages": []}

    monkeypatch.setattr(run_campaign, "run_recipe", run_recipe)


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("case", ["met", "missed", "raised"])
def test_campaign_verify(monkeypatch, capsys, tmp_path, case, verify):
    errors = {"ide_disc_kdv": 1e-4,
              "ide_cont_navierstokes": {"met": 5e-3, "missed": 2e-2,
                                        "raised": RuntimeError("boom")}[case]}
    ran = []
    _stub(monkeypatch, errors, ran)
    out = tmp_path / "rows.json"
    argv = ["ide_disc_kdv", "ide_cont_navierstokes", "--device", "cpu",
            "--quick", "--out", str(out)] + (["--verify"] if verify else [])
    rc = run_campaign.main(argv)
    text = capsys.readouterr().out
    assert ran == [("ide_disc_kdv", "cpu", True),
                   ("ide_cont_navierstokes", "cpu", True)]
    rows = json.loads(out.read_text())
    assert [r["experiment"] for r in rows] == (
        ["ide_disc_kdv"] if case == "raised"
        else ["ide_disc_kdv", "ide_cont_navierstokes"])
    if case == "raised":
        assert "ide_cont_navierstokes FAILED" in text
    lines = [line for line in text.splitlines() if line.startswith("VERIFY")]
    if not verify:
        assert lines == []
        assert rc == (1 if case == "raised" else 0)
        return
    want = ["VERIFY OK ide_disc_kdv: 1.0000e-04 vs budget 5.0e-04"]
    if case == "met":
        want += ["VERIFY OK ide_cont_navierstokes: 5.0000e-03 vs budget 1.0e-02",
                 "VERIFY PASSED"]
    elif case == "missed":
        want += ["VERIFY REGRESSED ide_cont_navierstokes: 2.0000e-02 vs "
                 "budget 1.0e-02", "VERIFY FAILED (ide_cont_navierstokes)"]
    else:
        want += ["VERIFY FAILED (ide_cont_navierstokes)"]
    assert lines == want
    assert rc == (0 if case == "met" else 1)


def test_campaign_defaults_to_the_parity_names(monkeypatch, capsys):
    ran = []
    _stub(monkeypatch, {n: 0.0 for n in run_campaign.CAMPAIGN}, ran)
    assert run_campaign.main(["--device", "cpu", "--verify"]) == 0
    assert [n for n, _, _ in ran] == run_campaign.PARITY_NAMES
    assert "ide_cont_navierstokes" not in run_campaign.PARITY_NAMES
    assert capsys.readouterr().out.splitlines()[-1] == "VERIFY PASSED"


@pytest.mark.parametrize("f32", [False, True])
def test_campaign_f32_stage_hp_matches_jax(jax_campaign, monkeypatch, f32):
    """Each experiment replaced by a stub that records its hp: both
    campaigns (the JAX one on the CPU) give every recipe's stages the same
    hp, ``--quick`` on, apart from the port-only ``device`` and
    checkpoint paths and two deviations by design: the port keeps
    ``fused_residual`` (the card's kernels), and keeps ``net_impl``
    without ``--f32`` (its df32 stages run as float64)."""
    import importlib
    import types

    seen = {"jax": [], "port": []}

    def stub(side):
        def run(hp, plot=False):
            assert plot is False
            seen[side].append(dict(hp))
            return {"error": 0.0, "timing": {}}
        return run

    for name in run_campaign.CAMPAIGN:
        monkeypatch.setitem(sys.modules, name,
                            types.SimpleNamespace(run=stub("jax")))
        monkeypatch.setattr(importlib.import_module(
            f"pinn_torch.experiments.{name}"), "run", stub("port"))
    paths = ("init_checkpoint", "save_checkpoint")
    for name, stages in run_campaign.CAMPAIGN.items():
        seen["jax"].clear()
        seen["port"].clear()
        jax_campaign.run_one(name, True, f32)
        run_campaign.run_recipe(name, "/nonexistent", "cpu", quick=True,
                                f32=f32)
        assert len(seen["jax"]) == len(seen["port"]) == len(stages)
        for i, (got, want) in enumerate(zip(seen["port"], seen["jax"])):
            assert got.pop("device") == "cpu"
            assert ("init_checkpoint" in got) == ("init_checkpoint" in want) \
                == (i > 0)
            kept = {k: got.pop(k) for k in ("fused_residual", "net_impl")
                    if k in got}
            assert kept == {k: v for k, v in stages[i].items()
                            if k == "fused_residual"
                            or (k == "net_impl" and not f32)}
            assert ({k: v for k, v in got.items() if k not in paths}
                    == {k: v for k, v in want.items() if k not in paths})
            if f32:
                assert got["dtype"] == "float32"
                assert "nt_vector_dtype" not in got


def test_campaign_refuses_unknown_names():
    with pytest.raises(SystemExit) as exc:
        run_campaign.main(["nope", "--device", "cpu"])
    assert exc.value.code == 2


def test_cli_campaign_delegates(monkeypatch):
    seen = []
    monkeypatch.setattr(run_campaign, "main", lambda argv: seen.append(argv) or 7)
    assert cli.main(["campaign", "ide_disc_kdv", "--verify"]) == 7
    assert seen == [["ide_disc_kdv", "--verify"]]


def test_run_list_names_every_experiment():
    done = _module("run", "--list")
    assert done.returncode == 0, done.stderr
    assert done.stdout.split() == EXPERIMENTS


def test_run_layers_defaults_file_and_set(monkeypatch, tmp_path, capsys):
    from pinn_torch.experiments import ide_cont_navierstokes as exp
    seen = []
    monkeypatch.setattr(exp, "run", lambda hp: seen.append(hp) or {"error": 0.25})
    path = tmp_path / "hp.json"
    path.write_text(json.dumps({"N_u": 300, "tf_epochs": 7}))
    rc = cli.main(["run", "ide_cont_navierstokes", str(path), "--set",
                   "tf_epochs=9", "--set=layers=[3, 8, 2]", "--set",
                   "device=cpu", "--set", "nt_lr=0.5", "--set", "N_f=null"])
    assert rc == 0
    hp, = seen
    assert hp == {**exp.DEFAULT_HP, "N_u": 300, "tf_epochs": 9,
                  "layers": [3, 8, 2], "device": "cpu", "nt_lr": 0.5,
                  "N_f": None}
    assert capsys.readouterr().out.strip() == "error: 2.5000e-01"


def test_run_refuses_bad_arguments():
    for argv in (["run"], ["run", "nope"], ["run", "ide_disc_kdv", "--set", "x"],
                 ["nope"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code not in (0, None)


@pytest.mark.parametrize("args", [["bench"], ["bench", "--smoke"]])
def test_not_ported_commands_refuse(args):
    done = _module(*args)
    assert done.returncode != 0
    assert "not ported yet" in done.stderr
    assert "Traceback" not in done.stderr


def test_info_names_torch_cuda_and_the_cards():
    import torch
    done = _module("info")
    assert done.returncode == 0, done.stderr
    lines = done.stdout.splitlines()
    assert lines[0].startswith("pinn_torch ")
    assert lines[1].startswith("torch ") and " CUDA " in lines[1]
    if torch.cuda.is_available():
        assert lines[2].strip().startswith("cuda:0")
    else:
        assert lines[2:] == ["  no CUDA device"]
