"""The port's evaluation sweep (`python -m mupe_tpu_torch.eval_sweep`, the
counterpart of scripts/eval_sweep.py), run tiny on the CPU: one `evaluate`
per fixed scenario in eval mode over the fixed layouts with 6 cylinder
slots, the JAX script's result keys, one JSON object printed and written to
`out=`."""
import inspect
import json
import runpy
import sys
from pathlib import Path

from mupe_tpu.envs.scenarios import EVAL_SCENARIOS as JEVAL_SCENARIOS
from mupe_tpu_torch import eval_sweep, harness
from mupe_tpu_torch.envs.scenarios import EVAL_SCENARIOS

ROOT = Path(__file__).resolve().parents[1]


def test_result_keys_are_the_jax_scripts():
    text = (ROOT / "scripts" / "eval_sweep.py").read_text()
    assert all(f'"{k}"' in text for k in eval_sweep.RESULT_KEYS)
    assert EVAL_SCENARIOS == JEVAL_SCENARIOS


def test_eval_sweep_module_runs_tiny_on_the_cpu(monkeypatch, capsys, tmp_path):
    calls, real = [], harness.evaluate

    def evaluate(argv, device="cuda"):
        calls.append(list(argv))
        return real(argv, device="cpu")

    monkeypatch.setattr(harness, "evaluate", evaluate)
    out = tmp_path / "sweep.json"
    monkeypatch.setattr(sys, "argv", ["eval_sweep", "env.num_envs=2", "env.max_episode_length=3",
                                      "env.scenario_flag=wall", f"out={out}"])
    monkeypatch.delitem(sys.modules, "mupe_tpu_torch.eval_sweep")  # run it afresh as __main__
    runpy.run_module("mupe_tpu_torch.eval_sweep", run_name="__main__")
    with open(out) as f:
        written = json.load(f)
    assert list(written) == list(EVAL_SCENARIOS)
    for flag, res in written.items():
        assert set(res) == set(eval_sweep.RESULT_KEYS), flag
        assert res["episodes"] == 2.0
    # each call: the scenario, eval mode over the fixed layout, 6 slots, no
    # stray scenario flag or out= passed on
    for flag, argv in zip(EVAL_SCENARIOS, calls):
        assert [a for a in argv if a.startswith("env.scenario_flag")] == [
            f"env.scenario_flag={flag}"]
        assert {"env.use_random_cylinder=false", "env.use_eval=true",
                "env.max_cylinders=6"} <= set(argv)
        assert not any(a.startswith("out=") for a in argv)
    printed = capsys.readouterr().out
    assert printed.count("--- scenario: ") == len(EVAL_SCENARIOS)
    assert json.loads(printed[printed.rindex("\n{") + 1:]) == written


def test_sweep_defaults_to_the_card():
    assert inspect.signature(eval_sweep.sweep).parameters["device"].default == "cuda"
