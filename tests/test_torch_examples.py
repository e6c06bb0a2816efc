"""The port's examples (`mupe_tpu_torch/examples/`) against the JAX
package's demos of the same name, on the CPU.

Each deterministic demo's `main(device="cpu")` runs at the JAX demo's size
and prints what the JAX demo prints; both outputs are read line by line:
the text between the numbers must be equal and each number within one unit
of its last printed digit (both sides round float32 results that agree to
~1e-6, so a printed digit may flip; measured: every line equal).  The
depth camera's ASCII frame must be equal character for character.  The
attitude demo's hover thrust is mass x gravity (m^2 g), so the drone falls
and is dragged about on the ground, where its attitude is chaotic: a
1e-7 rad/s change of JAX's own initial angular velocity moves its printed
angles by up to 0.17 rad (measured, JAX's functions run eagerly).  So it
is held against the JAX demo run under `jax.disable_jit()` in its first
segment, where exact zeros keep the level drone level on both sides
(XLA's fused program rounds otherwise and tips it to (-0.019, +0.084)
rad), and in its layout with finite values after.  demo_vision_policy
trains from random draws the two packages make with different generators, so its
numbers are not comparable: it runs at the JAX demo's size (256 arenas, 16
steps, 4 minibatches) for 5 of its 30 iterations (the first printed row;
30 take 80 s on one CPU thread) and its table is held to the JAX demo's
layout with finite values.  demo_hideandseek_rollout starts from the
scene the JAX demo's env draws for PRNGKey(0), handed to its `main`
(`bridge.env_state`); its 200 steps end every episode at the last step
only, so the one reset draws after every printed number and every frame:
no fresh scene needs injecting.  Its five stats are held as the other
demos' lines (measured: every line equal), and `--gif`'s file holds 100
frames (every 2nd of 200 steps) decoded by tests/test_torch_render.py's
decoder.
"""
import contextlib
import importlib
import importlib.util
import io
import math
import re
from pathlib import Path

import jax
import pytest
import torch

from mupe_tpu_torch import examples

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
# held by their own tests below: trained from random draws / started from
# JAX's scene
OWN_TESTS = ("demo_vision_policy", "demo_hideandseek_rollout")
DETERMINISTIC = [e for e in examples.EXAMPLES if e not in OWN_TESTS]
NUMBER = re.compile(r"[-+]?\d+\.\d+|[-+]?\d+")
# the lines held number by number, where the rest of a demo is chaotic
CHAOTIC_AFTER = {"demo_attitude_tracking": 2}


def _printed(fn, *args, **kw) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


def _jax_demo(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_line(got: str, want: str) -> None:
    assert NUMBER.split(got) == NUMBER.split(want), (got, want)
    for g, w in zip(NUMBER.findall(got), NUMBER.findall(want)):
        unit = 10.0 ** -len(w.split(".")[1]) if "." in w else 1.0
        assert abs(float(g) - float(w)) <= 1.01 * unit, (got, want)


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_example_prints_what_the_jax_demo_prints(name):
    demo = _jax_demo(name)
    if name == "demo_attitude_tracking":
        with jax.disable_jit():
            want = _printed(demo.main)
    else:
        want = _printed(demo.main)
    got = _printed(importlib.import_module(f"mupe_tpu_torch.examples.{name}").main, device="cpu")
    assert len(got) == len(want) and got
    if name == "demo_depth_camera":
        assert got == want
    strict = CHAOTIC_AFTER.get(name, len(want))
    for g, w in zip(got[:strict], want[:strict]):
        _same_line(g, w)
    for g, w in zip(got[strict:], want[strict:]):
        assert NUMBER.split(g) == NUMBER.split(w), (g, w)
        assert all(math.isfinite(float(v)) for v in NUMBER.findall(g))


def test_vision_policy_example_trains():
    from mupe_tpu_torch.examples import demo_vision_policy

    lines = _printed(demo_vision_policy.main, device="cpu", iters=5)
    assert lines[0] == "iter  policy_loss  value_loss  pos_error  episodes"
    assert lines[-1].startswith("done")
    row = lines[1].split()
    assert row[0] == "5" and len(row) in (5, 4)  # "(none)" where no episode ended
    values = [float(v) for v in row[1:] if v != "(none)"]
    assert all(math.isfinite(v) for v in values)


def test_hideandseek_rollout_prints_what_the_jax_demo_prints(tmp_path):
    from mupe_tpu.envs.hideandseek import HideAndSeek as JHideAndSeek
    from mupe_tpu.envs.hideandseek import HideAndSeekCfg as JHideAndSeekCfg
    from mupe_tpu_torch import bridge
    from mupe_tpu_torch.examples import demo_hideandseek_rollout
    from test_torch_hideandseek import to_np
    from test_torch_render import decode_gif

    want = _printed(_jax_demo("demo_hideandseek_rollout").main)
    jenv = JHideAndSeek(JHideAndSeekCfg(num_envs=4, max_episode_length=200, use_tp_net=False))
    state = bridge.env_state(to_np(jenv.reset(jax.random.PRNGKey(0))))
    path = tmp_path / "demo.gif"
    got = _printed(demo_hideandseek_rollout.main, device="cpu", gif=str(path), state=state)
    assert len(got) == len(want) + 1 == 7 and got[-1] == f"gif: {path}"
    for g, w in zip(got, want):
        _same_line(g, w)
    assert len(decode_gif(path.read_bytes())["frames"]) == 100


def test_examples_default_to_the_card():
    assert examples.device_arg([]) == "cuda"
    assert examples.device_arg(["--device", "cpu"]) == "cpu"
