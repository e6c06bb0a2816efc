#!/usr/bin/env python3
"""Hashes of the kernels' outputs at fixed draws, to show that two trees give
the same bits, on one GPU.

    python3 scripts/torch_kernel_bits.py [--tree DIR] --out FILE.json

Runs the port found in DIR (default: this checkout) at specs that every tree
with the 16-token kernel instances takes: the encoder pair forward, the
one-network forward, the pair backward (both stages) and the agrad kernel
at the main spec
((1, 35), (3, 5), (2, 3)), at 8 tokens with a 50-wide group and at 16 tokens
over 148 columns, at S = 17 and 4,099; and the TP forward and backward at
F 16 / T 10 / O 15, F 34 / T 20 / O 30 and F 64 / T 32 / O 64, N = 17 and
4,097.  Writes {case: sha256 of the outputs' bytes}.  Two trees' files are
compared with `--compare A.json B.json` (exit 1 if a case differs).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
from pathlib import Path

SPECS = {"main": ((1, 35), (3, 5), (2, 3)), "8 tokens": ((1, 50), (4, 5), (3, 3)),
         "16 tokens": ((1, 83), (10, 5), (5, 3))}
TP_SHAPES = ((16, 10, 15), (34, 20, 30), (64, 32, 64))


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def leaves(shapes, gen, dev):
    import torch

    return [(torch.randn(s, generator=gen) / math.sqrt(s[0]) if len(s) == 2
             else 0.1 * torch.randn(s, generator=gen)).to(dev) for s in shapes]


def run(dev) -> dict:
    import torch

    from mupe_tpu_torch.ops import fused_encoder as fe
    from mupe_tpu_torch.ops import tp_lstm as tl

    out = {}
    for name, groups in SPECS.items():
        for s in (17, 4099):
            gen = torch.Generator().manual_seed(s)
            spec_a = fe.EncoderSpec(groups=groups, head_dim=4)
            spec_c = fe.EncoderSpec(groups=groups, head_dim=1)
            la = leaves(fe.leaf_shapes(spec_a), gen, dev)
            lc = leaves(fe.leaf_shapes(spec_c), gen, dev)
            x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
            da = torch.randn((s, 4), generator=gen).to(dev)
            dc = torch.randn((s, 1), generator=gen).to(dev)
            tag = f"{name} S={s}"
            out[f"encoder_pair_forward {tag}"] = digest(fe.encoder_pair_forward(spec_a, spec_c,
                                                                                la, lc, x))
            out[f"encoder_forward {tag}"] = digest([fe.encoder_forward(spec_c, lc, x)])
            ga, gc = fe.encoder_backward([(spec_a, la), (spec_c, lc)], x, [da, dc])
            out[f"encoder_backward {tag}"] = digest([*ga, *gc])
            log_std = -1.0 + 0.3 * torch.randn(4, generator=gen).to(dev)
            rows = [torch.randn((s, 4), generator=gen).to(dev)] + [
                torch.randn((s, 1), generator=gen).to(dev) for _ in range(4)]
            loss = fe.PPOLossCfg(clip_param=0.2, huber_delta=10.0, action_dim=4, n_rows=s)
            dv1, dv2, stats, grads = fe.pair_forward_loss_agrad(spec_a, spec_c, loss, la, lc,
                                                               log_std, x, *rows)
            out[f"pair_forward_loss_agrad {tag}"] = digest([dv1, dv2, stats, *grads])
    for f, t, o in TP_SHAPES:
        for n in (17, 4097):
            gen = torch.Generator().manual_seed(n + f)
            spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
            lt = leaves(spec.leaf_shapes(), gen, dev)
            x = torch.randn((n, t, f), generator=gen).to(dev)
            dy = torch.randn((n, o), generator=gen).to(dev)
            tag = f"F={f} T={t} O={o} N={n}"
            out[f"tp_forward {tag}"] = digest([tl.tp_forward(spec, lt, x)])
            out[f"tp_backward {tag}"] = digest(tl.tp_backward(spec, lt, x, dy))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(Path(p).read_text()) for p in args.compare)
        differ = sorted(k for k in a.keys() & b.keys() if a[k] != b[k])
        print(f"{len(a.keys() & b.keys())} cases, {len(differ)} differ: {differ}")
        return 1 if differ or a.keys() != b.keys() else 0
    sys.path.insert(0, args.tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_bits: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run(torch.device("cuda", 0))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"{len(out)} cases -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
