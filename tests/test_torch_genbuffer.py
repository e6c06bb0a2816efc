"""The AEG task buffer of the port against the JAX package
(mupe_tpu/envs/genbuffer.py), with the JAX package's random draws handed to
the port's deterministic parts.

`insert_weights` + `update_history` on both of its paths (the pack path
when the kept tasks fit, farthest-point downsampling when they overflow),
as tests/test_placement.py drives them: `history_len` and `num_added`
exact, the history to 1e-6 (both sides copy the same f32 rows; FPS picks
the same indices).  `_sanity_check` and the deterministic part of
`sample_nearby` (the same f32 additions and clips of the same draws): exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.envs import genbuffer as jgb
from mupe_tpu_torch.envs import genbuffer as tgb
from mupe_tpu_torch.envs.hideandseek_envgen import HideAndSeekEnvgen, HideAndSeekEnvgenCfg
from mupe_tpu_torch.envs.placement import make_grid

N_AG, N_CYL = 3, 5
TASK_DIM = 3 * N_AG + 3 + 3 * N_CYL
GRID = make_grid(0.9, 0.1)


def to_port(gb) -> tgb.GenBufferState:
    return tgb.GenBufferState(**{f.name: torch.as_tensor(np.array(getattr(gb, f.name)))
                                 for f in dataclasses.fields(gb)})


@pytest.fixture(scope="module")
def tasks():
    """Realistic tasks: the uniform scene sampler (feasible layouts, not all
    on distinct cells)."""
    env = HideAndSeekEnvgen(HideAndSeekEnvgenCfg(num_envs=32), device="cpu")
    return env._uniform_tasks(torch.Generator().manual_seed(0)).numpy()


@pytest.mark.parametrize("path", ["pack", "fps"])
def test_update_history_matches_jax(path):
    rng = np.random.default_rng(0 if path == "pack" else 1)
    cap, e = 16, 24
    # three eval episodes of per-env success in {0, 1}: means in {0, 1/3, 2/3, 1}
    weights = [(rng.random(e) < 0.6).astype(np.float32) for _ in range(3)]
    hist_len = 3 if path == "pack" else 12
    jgb0 = jgb.GenBufferState.create(cap, e, TASK_DIM, ratio_unif=0.3).replace(
        history=jnp.asarray(rng.normal(size=(cap, TASK_DIM)).astype(np.float32)),
        history_len=jnp.asarray(hist_len, jnp.int32),
        eval_tasks=jnp.asarray(rng.normal(size=(e, TASK_DIM)).astype(np.float32)),
    )
    tgb0 = to_port(jgb0)
    for w in weights:
        jgb0 = jgb.insert_weights(jgb0, jnp.asarray(w))
        tgb0 = tgb.insert_weights(tgb0, torch.as_tensor(w))
    np.testing.assert_array_equal(tgb0.weight_sum.numpy(), np.asarray(jgb0.weight_sum))
    assert int(tgb0.weight_count) == int(jgb0.weight_count) == 3

    jout, jadded = jgb.update_history(jgb0, r_min=0.5, r_max=0.9)
    tout, tadded = tgb.update_history(tgb0, r_min=0.5, r_max=0.9)
    assert int(tadded) == int(jadded)
    total = hist_len + int(jadded)
    assert (total > cap) == (path == "fps")
    assert int(tout.history_len) == int(jout.history_len) == min(total, cap)
    np.testing.assert_allclose(tout.history.numpy(), np.asarray(jout.history), rtol=0, atol=1e-6)
    assert float(tout.weight_sum.abs().sum()) == 0.0 and int(tout.weight_count) == 0


def test_sanity_check_matches_jax(tasks):
    rng = np.random.default_rng(2)
    cand = tasks[None] + rng.normal(0.0, 0.15, size=(4,) + tasks.shape).astype(np.float32)
    cand = np.concatenate([tasks[None], cand])                   # [5, 32, D]
    want = np.asarray(jgb._sanity_check(jnp.asarray(cand), GRID, N_AG, N_CYL))
    got = tgb._sanity_check(torch.as_tensor(cand), GRID, N_AG, N_CYL).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()                        # both outcomes occur


@pytest.mark.parametrize("expand_cylinders", [False, True])
def test_sample_nearby_deterministic_part_matches_jax(tasks, expand_cylinders):
    cap, num, tries = 32, 24, 10
    gb = jgb.GenBufferState.create(cap, num, TASK_DIM, 0.3).replace(
        history=jnp.asarray(tasks), history_len=jnp.asarray(20, jnp.int32))
    key = jax.random.PRNGKey(5)
    kw = dict(expand_step=0.25, expand_cylinders=expand_cylinders, arena_size=0.9,
              max_height=1.2)
    want = np.asarray(jgb.sample_nearby(key, gb, num, GRID, N_AG, N_CYL, num_tries=tries, **kw))
    # JAX's draws, as sample_nearby makes them
    k_pick, k_noise = jax.random.split(key)
    pick = jax.random.randint(k_pick, (num,), 0, 20)
    k_dt, k_cyl = jax.random.split(k_noise)
    dt_u = jax.random.uniform(k_dt, (tries, num, 3 * (N_AG + 1)), minval=-1.0, maxval=1.0)
    steps = jax.random.randint(k_cyl, (tries, num, N_CYL, 2), -1, 2)
    got = tgb.nearby_from_draws(
        to_port(gb), torch.as_tensor(np.array(pick)).long(), torch.as_tensor(np.array(dt_u)),
        torch.as_tensor(np.array(steps)), GRID, N_AG, N_CYL, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    moved = np.any(got != tasks[np.asarray(pick)], axis=-1)   # else the original is kept
    ok = tgb._sanity_check(torch.as_tensor(got), GRID, N_AG, N_CYL).numpy()
    assert moved.any() and ok[moved].all()


def test_draws_stay_inside_the_valid_prefix():
    gb = tgb.GenBufferState.create(16, 4, TASK_DIM, 0.3)
    gb.history_len = torch.tensor(5, dtype=torch.int32)
    pick, dt_u, steps = tgb.draw_nearby(torch.Generator().manual_seed(0), gb, 4000, N_AG, N_CYL)
    assert int(pick.min()) == 0 and int(pick.max()) == 4
    assert float(dt_u.min()) >= -1.0 and float(dt_u.max()) < 1.0
    assert set(steps.unique().tolist()) == {-1, 0, 1}
    gb.history = torch.arange(16, dtype=torch.float32)[:, None].expand(16, TASK_DIM)
    rows = tgb.sample_history(torch.Generator().manual_seed(2), gb, 500)
    assert set(rows[:, 0].tolist()) == {0.0, 1.0, 2.0, 3.0, 4.0}
    gb.history_len = torch.tensor(0, dtype=torch.int32)
    assert int(tgb.draw_pick(torch.Generator().manual_seed(1), gb, 50).max()) == 0
