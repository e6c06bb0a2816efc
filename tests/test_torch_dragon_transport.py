"""Dragon, the slung-payload transport group and the quadrotor step's
external force in the PyTorch port against the JAX package, on the CPU.

Both sides step from the same perturbed state (JAX's, carried across by
`bridge.dragon_state` / `bridge.transport_state`) in float32 with the same
formulas in the same order.  One call agrees to float32 rounding: every
field within 1e-5 of its scale, max(1, its largest magnitude) (measured: at
most 8.9e-8 of it).  Trajectories of 100 control steps (400 substeps)
accumulate that rounding through stiff springs: positions held within
1e-4 m (measured: Dragon 1.0e-6 m with gimbal and joint commands, the
transport group under the Lee controller 1.2e-7 m).  The physical checks
of tests/test_dragon.py and tests/test_transport.py run on the port's side.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.controllers.lee import lee_position_control as jlee
from mupe_tpu.controllers.lee import make_mixer as jmake_mixer
from mupe_tpu.dynamics import DroneState as JDrone
from mupe_tpu.dynamics import dragon as jdragon
from mupe_tpu.dynamics import make_params as jmake_params
from mupe_tpu.dynamics import step as jstep
from mupe_tpu.dynamics import transport as jtransport
from mupe_tpu_torch import bridge
from mupe_tpu_torch.controllers import lee_position_control, make_mixer
from mupe_tpu_torch.dynamics import DroneState, make_params, step
from mupe_tpu_torch.dynamics import dragon as tdragon
from mupe_tpu_torch.dynamics import transport as ttransport

torch.set_num_threads(1)
REL = 1e-5         # one call, of each field's scale
TRAJ_ATOL = 1e-4   # 100 control steps, positions [m]
DT = 0.01
CFG = tdragon.DragonCfg()


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


def _held(t, j, rel=REL):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert float(np.abs(t - j).max()) <= rel * scale


def _tree_np(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree_np(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def _fields(state):
    """(name, tensor) of a state, the drones' fields of a transport state."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out += [(f"{f.name}.{k}", t) for k, t in _fields(v)]
        else:
            out.append((f.name, v))
    return out


def _held_states(t, j, rel=REL):
    for (name, tv), (_, jv) in zip(_fields(t), _fields(j)):
        _held(tv, jv, rel)


def _hover_cmd() -> float:
    return 2.0 * (CFG.link_mass * 9.81 / (2.0 * CFG.kf)) - 1.0


def _dragon_state(e, seed):
    """JAX's chain at hover, perturbed: positions, orientations, velocities,
    throttles and gimbal angles."""
    rng = np.random.default_rng(seed)
    s = jdragon.dragon_init(jdragon.DragonCfg(), jnp.zeros((e, 3)).at[:, 2].set(1.0))
    d = _tree_np(s)
    L = d["pos"].shape[1]
    q = d["quat"] + rng.normal(0, 0.05, (e, L, 4))
    d["quat"] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    d["pos"] = (d["pos"] + rng.normal(0, 0.01, d["pos"].shape)).astype(np.float32)
    d["vel"] = rng.normal(0, 0.2, d["vel"].shape).astype(np.float32)
    d["angvel"] = rng.normal(0, 0.5, d["angvel"].shape).astype(np.float32)
    d["throttle"] = rng.uniform(0.3, 0.9, d["throttle"].shape).astype(np.float32)
    d["gimbal"] = rng.uniform(-0.3, 0.3, d["gimbal"].shape).astype(np.float32)
    return jdragon.DragonLinkState(**{k: jnp.asarray(v) for k, v in d.items()}), d


def _dragon_actions(steps, e, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 0.5, (steps, e, CFG.action_dim)).astype(np.float32)
    a[..., :CFG.num_rotors] = _hover_cmd() + rng.uniform(-0.05, 0.05, (steps, e, CFG.num_rotors))
    return a


def test_dragon_layout_matches_jax():
    j = jdragon.DragonCfg()
    for k in ("num_rotors", "action_split", "action_dim", "state_dim", "kf", "km"):
        assert getattr(CFG, k) == getattr(j, k), k
    assert CFG.action_split == (8, 8, 6) and CFG.state_dim == 98
    _held_states(tdragon.dragon_init(CFG, torch.tensor([[0.0, 0.0, 1.0], [1.0, 2.0, 3.0]])),
                 jdragon.dragon_init(j, jnp.asarray([[0.0, 0.0, 1.0], [1.0, 2.0, 3.0]])))


def test_dragon_step_and_state_vector_match_jax():
    js, d = _dragon_state(8, 0)
    ts = bridge.dragon_state(d)
    a = _dragon_actions(1, 8, 1)[0]
    # a link exactly antipodal in w (w = 0): the small angles' sign is 1
    d0 = dict(d, quat=d["quat"].copy())
    d0["quat"][0, 1] = [0.0, 0.6, 0.0, 0.8]
    for jstate, tstate in ((js, ts), (jdragon.DragonLinkState(**{k: jnp.asarray(v) for k, v
                                                                in d0.items()}),
                                      bridge.dragon_state(d0))):
        _held(tdragon.dragon_state_vector(CFG, tstate),
              jdragon.dragon_state_vector(jdragon.DragonCfg(), jstate))
        _held_states(tdragon.dragon_step(CFG, tstate, torch.as_tensor(a), DT),
                     jdragon.dragon_step(jdragon.DragonCfg(), jstate, jnp.asarray(a), DT))


def test_dragon_trajectory_matches_jax():
    """100 control steps with rotor, gimbal and joint commands."""
    js, d = _dragon_state(4, 2)
    acts = _dragon_actions(100, 4, 3)
    jcfg = jdragon.DragonCfg()

    def body(s, a):
        s = jdragon.dragon_step(jcfg, s, a, DT)
        return s, s.pos

    _, jpos = jax.jit(lambda s, a: jax.lax.scan(body, s, a))(js, jnp.asarray(acts))
    ts, tpos = bridge.dragon_state(d), []
    for a in acts:
        ts = tdragon.dragon_step(CFG, ts, torch.as_tensor(a), DT)
        tpos.append(ts.pos)
    np.testing.assert_allclose(_np(torch.stack(tpos)), np.asarray(jpos), atol=TRAJ_ATOL)


def _dragon_rollout(action_fn, steps, e=4):
    s = tdragon.dragon_init(CFG, torch.tensor([[0.0, 0.0, 1.0]]).expand(e, 3).contiguous())
    for i in range(steps):
        s = tdragon.dragon_step(CFG, s, action_fn(i, s), DT)
    return s


def _hover_action(e=4):
    a = torch.zeros((e, CFG.action_dim))
    a[:, :CFG.num_rotors] = _hover_cmd()
    return a


def test_dragon_hover_is_stable_and_chain_holds():
    pos = _np(_dragon_rollout(lambda i, s: _hover_action(), 200).pos)
    assert np.isfinite(pos).all()
    gaps = np.linalg.norm(pos[:, 1:] - pos[:, :-1], axis=-1)
    assert (np.abs(gaps - CFG.link_spacing) < 0.1).all()
    assert (np.abs(pos[..., 2] - 1.0) < 0.5).all()


def test_dragon_gimbal_tilt_produces_lateral_motion():
    a = _hover_action()
    a[:, :CFG.num_rotors] *= 1.02
    a[:, CFG.num_rotors:CFG.num_rotors + 8:2] = 0.5   # tilt about link y
    s = _dragon_rollout(lambda i, s: a, 150)
    assert float(s.vel[..., 0].mean()) > 0.05


def test_dragon_link_joint_drive_bends_chain():
    a = _hover_action()
    a[:, CFG.num_rotors + 9::2] = 0.6                 # every joint about z
    pos = _np(_dragon_rollout(lambda i, s: a, 300).pos)
    end_to_end = np.linalg.norm(pos[:, -1] - pos[:, 0], axis=-1)
    assert (end_to_end < CFG.link_spacing * (CFG.num_links - 1) - 0.05).all()
    assert np.isfinite(pos).all()


# ------------------------------------------------------------------ transport
TCFG = ttransport.TransportCfg()
JTCFG = jtransport.TransportCfg()


def test_quadrotor_step_external_force_matches_jax():
    rng = np.random.default_rng(4)
    d = dict(pos=(rng.uniform(-1, 1, (6, 4, 3)) + [0, 0, 2]).astype(np.float32),
             quat=np.tile(np.float32([1, 0, 0, 0]), (6, 4, 1)),
             vel=rng.normal(0, 0.3, (6, 4, 3)).astype(np.float32),
             angvel=rng.normal(0, 0.5, (6, 4, 3)).astype(np.float32),
             throttle=rng.uniform(0.3, 0.9, (6, 4, 6)).astype(np.float32))
    cmds = rng.uniform(-1, 1, (6, 4, 6)).astype(np.float32)
    force = rng.normal(0, 5.0, (6, 4, 3)).astype(np.float32)
    js, jd = jstep(jmake_params("firefly"), JDrone(**{k: jnp.asarray(v) for k, v in d.items()}),
                   jnp.asarray(cmds), 0.004, ext_force_w=jnp.asarray(force))
    ts, td = step(make_params("firefly"), DroneState(**{k: torch.as_tensor(v)
                                                         for k, v in d.items()}),
                  torch.as_tensor(cmds), 0.004, ext_force_w=torch.as_tensor(force))
    _held_states(ts, js)
    _held(td, jd)
    # None keeps the step's bits
    a, _ = step(make_params("firefly"), DroneState(**{k: torch.as_tensor(v) for k, v in d.items()}),
                torch.as_tensor(cmds), 0.004)
    b, _ = step(make_params("firefly"), DroneState(**{k: torch.as_tensor(v) for k, v in d.items()}),
                torch.as_tensor(cmds), 0.004, ext_force_w=None)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_fields(a), _fields(b)))


def test_transport_init_geometry_matches_jax():
    origin = np.asarray([[0.0, 0.0, 1.5], [1.0, -2.0, 3.0]], np.float32)
    js = jtransport.transport_init(JTCFG, jtransport.make_transport_params(JTCFG),
                                   jnp.asarray(origin))
    ts = ttransport.transport_init(TCFG, ttransport.make_transport_params(TCFG),
                                   torch.as_tensor(origin))
    _held_states(ts, js)
    for k in ("drone_offsets", "anchor_body", "payload_inertia"):
        np.testing.assert_array_equal(_np(getattr(TCFG, k)), np.asarray(getattr(JTCFG, k)))
    # the rods start taut
    d = np.linalg.norm(_np(ts.drones.pos) - (_np(ts.payload_pos)[:, None] + _np(TCFG.anchor_body)),
                       axis=-1)
    np.testing.assert_allclose(d, TCFG.bar_length, atol=1e-6)
    np.testing.assert_allclose(_np(ts.payload_pos)[0], [0.0, 0.0, 0.4], atol=1e-7)


def _transport_state(e, seed):
    rng = np.random.default_rng(seed)
    origin = np.zeros((e, 3), np.float32)
    origin[:, 2] = 1.5
    s = jtransport.transport_init(JTCFG, jtransport.make_transport_params(JTCFG),
                                  jnp.asarray(origin))
    d = _tree_np(s)
    dr = d["drones"]
    dr["pos"] = (dr["pos"] + rng.normal(0, 0.02, dr["pos"].shape)).astype(np.float32)
    dr["vel"] = rng.normal(0, 0.1, dr["vel"].shape).astype(np.float32)
    dr["angvel"] = rng.normal(0, 0.2, dr["angvel"].shape).astype(np.float32)
    q = d["payload_quat"] + rng.normal(0, 0.03, d["payload_quat"].shape)
    d["payload_quat"] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    d["payload_vel"] = rng.normal(0, 0.1, (e, 3)).astype(np.float32)
    d["payload_omega"] = rng.normal(0, 0.2, (e, 3)).astype(np.float32)
    j = jtransport.TransportState(
        drones=JDrone(**{k: jnp.asarray(v) for k, v in dr.items()}),
        **{k: jnp.asarray(v) for k, v in d.items() if k != "drones"})
    return j, d


def test_transport_step_matches_jax():
    js, d = _transport_state(4, 5)
    ts = bridge.transport_state(d)
    cmds = np.random.default_rng(6).uniform(-0.2, 0.6, (4, 4, 6)).astype(np.float32)
    _held_states(ttransport.transport_step(TCFG, ttransport.make_transport_params(TCFG), ts,
                                           torch.as_tensor(cmds), 0.016),
                 jtransport.transport_step(JTCFG, jtransport.make_transport_params(JTCFG), js,
                                           jnp.asarray(cmds), 0.016))


def test_transport_trajectory_under_lee_matches_jax():
    """100 ticks of the Lee controller holding the perturbed group."""
    js, d = _transport_state(2, 7)
    jp, jm = jtransport.make_transport_params(JTCFG), jmake_mixer("firefly")
    targets = np.asarray(d["drones"]["pos"]) + np.float32([0.3, 0.0, 0.2])

    def tick(s, _):
        cmds = jlee(jm, s.drones.pos, s.drones.quat, s.drones.vel, s.drones.angvel,
                    jnp.asarray(targets))
        s = jtransport.transport_step(JTCFG, jp, s, cmds, 0.016)
        return s, (s.drones.pos, s.payload_pos)

    _, (jdp, jpp) = jax.jit(lambda s: jax.lax.scan(tick, s, None, length=100))(js)
    tp, tm = ttransport.make_transport_params(TCFG), make_mixer("firefly")
    ts, dp, pp = bridge.transport_state(d), [], []
    for _ in range(100):
        cmds = lee_position_control(tm, ts.drones.pos, ts.drones.quat, ts.drones.vel,
                                    ts.drones.angvel, torch.as_tensor(targets))
        ts = ttransport.transport_step(TCFG, tp, ts, cmds, 0.016)
        dp.append(ts.drones.pos)
        pp.append(ts.payload_pos)
    np.testing.assert_allclose(_np(torch.stack(dp)), np.asarray(jdp), atol=TRAJ_ATOL)
    np.testing.assert_allclose(_np(torch.stack(pp)), np.asarray(jpp), atol=TRAJ_ATOL)


def test_transport_hover_closed_loop_stable():
    """The Lee controller holds two groups at their spawn points for 400
    ticks: the payload hangs below the drones, the rods near their length,
    the drones near their targets, the payload level."""
    params, mixer = ttransport.make_transport_params(TCFG), make_mixer(TCFG.drone_model)
    st = ttransport.transport_init(TCFG, params, torch.tensor([[0.0, 0.0, 1.5],
                                                               [1.0, 0.0, 1.5]]))
    targets = st.drones.pos.clone()
    for _ in range(400):
        cmds = lee_position_control(mixer, st.drones.pos, st.drones.quat, st.drones.vel,
                                    st.drones.angvel, targets)
        st = ttransport.transport_step(TCFG, params, st, cmds, 0.016)
    pos, pay = _np(st.drones.pos), _np(st.payload_pos)
    assert np.isfinite(pos).all() and np.isfinite(pay).all()
    assert (pay[:, 2] > -0.5).all() and (pos[..., 2].min(axis=-1) > pay[:, 2]).all()
    d = np.linalg.norm(pos - (pay[:, None] + _np(TCFG.anchor_body)), axis=-1)
    assert (np.abs(d - TCFG.bar_length) < 0.1).all(), d
    assert (np.abs(pos - _np(targets))[..., :2] < 0.5).all()
    assert (np.abs(pos[..., 2] - _np(targets)[..., 2]) < 1.5).all()
    assert abs(float(st.payload_quat[0, 0])) > 0.95


def test_transport_payload_couples_dynamics():
    """Rotors at minimum: the whole assembly, payload included, falls."""
    cfg = ttransport.TransportCfg(substeps=2)
    params = ttransport.make_transport_params(cfg)
    st = ttransport.transport_init(cfg, params, torch.tensor([[0.0, 0.0, 3.0]]))
    z0 = float(st.payload_pos[0, 2])
    cmds = -torch.ones((1, 4, st.drones.throttle.shape[-1]))
    for _ in range(60):
        st = ttransport.transport_step(cfg, params, st, cmds, 0.016)
    assert float(st.payload_pos[0, 2]) < z0 - 1.0
    assert np.isfinite(_np(st.drones.pos)).all()


def test_unknown_drone_model_is_refused():
    with pytest.raises(KeyError):
        ttransport.make_transport_params(ttransport.TransportCfg(drone_model="nope"))
