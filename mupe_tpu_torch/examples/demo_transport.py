"""Slung-payload transport: four Firefly drones carry a 2 kg payload on
rigid bars, held by the Lee position controller along a ramped setpoint;
prints the trim the assembly settles into (counterpart of
examples/demo_transport.py).

    python -m mupe_tpu_torch.examples.demo_transport [--device cpu]
"""
import numpy as np
import torch

from mupe_tpu_torch.controllers import lee_position_control, make_mixer
from mupe_tpu_torch.dynamics.transport import (TransportCfg, make_transport_params,
                                               transport_init, transport_step)
from mupe_tpu_torch.examples import device_arg


def main(device: str = "cuda") -> None:
    cfg = TransportCfg()
    params = make_transport_params(cfg, device)
    mixer = make_mixer(cfg.drone_model, device)
    st = transport_init(cfg, params, torch.tensor([[0.0, 0.0, 1.5]], device=device))
    start = st.drones.pos
    goal = start + torch.tensor([3.0, 0.0, 0.7], device=device)

    for k in range(9):
        # ramp the setpoint: a 3 m step saturates the geometric controller
        # and tumbles the slung assembly
        fracs = torch.clamp((torch.arange(100, device=device) + k * 100) / 600.0, 0.0, 1.0)
        for frac in fracs:
            targets = start + frac[..., None, None, None] * (goal - start)
            cmds = lee_position_control(mixer, st.drones.pos, st.drones.quat, st.drones.vel,
                                        st.drones.angvel, targets)
            st = transport_step(cfg, params, st, cmds, dt=0.016)
        pos = st.drones.pos[0].cpu().numpy()
        pay = st.payload_pos[0].cpu().numpy()
        err = np.linalg.norm(pos - goal[0].cpu().numpy(), axis=-1).mean()
        print(f"t={(k + 1) * 100 * 0.016:5.1f}s  mean drone target err {err:.3f} m"
              f"  payload at ({pay[0]:+.2f}, {pay[1]:+.2f}, {pay[2]:+.2f})")
    d = np.linalg.norm(st.drones.pos[0].cpu().numpy()
                       - (st.payload_pos[0].cpu().numpy() + cfg.anchor_body.numpy()), axis=-1)
    print(f"rod lengths: {np.round(d, 3)} (bar_length={cfg.bar_length})")


if __name__ == "__main__":
    main(device_arg())
