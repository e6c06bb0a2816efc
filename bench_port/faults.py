"""Faults planted in the program, which the check must catch: each a
context manager that patches mupe_tpu_torch for its duration.  The CPU
tests run a cell under each and expect `correct` to read false; the
readings script runs them on the chip for the limits' upper readings.

Training (`TRAIN`): `unchanged`, an optimizer step that returns the state
unchanged; `half`, half of each minibatch left out and the mean taken over
the rest; `token`, an observation token (an entity group's first value, or
a flat observation's) altered in one arena where `env.step` produces it.
Evaluation (`EVAL`): `unchanged`, an env step that returns the state it
was given; `half`, the second half of the arenas' episodes never ending,
so the means are over the rest; `answer`, a stat of the evaluation's
result altered.
"""
from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(obj, attr, make):
    raw = vars(obj)[attr]   # a class's staticmethod stays one when put back
    setattr(obj, attr, make(getattr(obj, attr)))
    try:
        yield
    finally:
        setattr(obj, attr, raw)


def train_unchanged():
    from mupe_tpu_torch.learning import mappo

    return _patched(mappo.MAPPOPolicy, "_write", lambda f: staticmethod(
        lambda params, new, opt, new_opt, stop: None))


@contextlib.contextmanager
def train_half():
    from mupe_tpu_torch.learning import mappo

    def halves(f):
        def local(mb_idx, e_local, shard):
            return [idx[: idx.shape[0] // 2] for idx in f(mb_idx, e_local, shard)]
        return local

    count = staticmethod(lambda mb, mb_rows: int(mb["logp"].numel()))
    with _patched(mappo, "local_minibatches", halves), \
            _patched(mappo.MAPPOPolicy, "_count", lambda f: count):
        yield


def train_token(task="HideAndSeek"):
    def step(f):
        def wrapped(self, state, action, *a, **kw):
            new, tr = f(self, state, action, *a, **kw)
            obs = dict(tr.obs) if isinstance(tr.obs, dict) else tr.obs.clone()
            if isinstance(obs, dict):
                key = sorted(obs)[0]
                obs[key] = obs[key].clone()
                obs[key].view(-1)[0] += 1.0
            else:
                obs.view(-1)[0] += 1.0
            return new, dataclasses.replace(tr, obs=obs)
        return wrapped

    return _patched(_env_class(task), "step", step)


def _env_class(task):
    from mupe_tpu_torch.envs import ENV_REGISTRY

    return ENV_REGISTRY[task]


def eval_unchanged(task="HideAndSeek"):
    def step(f):
        def wrapped(self, state, action, *a, **kw):
            _, tr = f(self, state, action, *a, **kw)
            return state, tr
        return wrapped

    return _patched(_env_class(task), "step", step)


def eval_half(task="HideAndSeek"):
    def step(f):
        def wrapped(self, state, action, *a, **kw):
            new, tr = f(self, state, action, *a, **kw)
            done = tr.done.clone()
            done[done.shape[0] // 2:] = False
            return new, dataclasses.replace(tr, done=done)
        return wrapped

    return _patched(_env_class(task), "step", step)


def eval_answer(task="HideAndSeek"):
    from mupe_tpu_torch import harness

    def make(f):
        def make_prog(*a, **kw):
            prog = f(*a, **kw)

            def altered(ts, i):
                out = dict(prog(ts, i))
                key = sorted(k for k in out if k != "episode_count")[0]
                out[key] = out[key] + 0.5
                return out
            return altered
        return make_prog

    return _patched(harness, "_make_eval_prog", make)


TRAIN = {"unchanged": train_unchanged, "half": train_half, "token": train_token}
EVAL = {"unchanged": eval_unchanged, "half": eval_half, "answer": eval_answer}


def plant(kind: str, name: str, task: str):
    """The fault `name` of a cell of traffic `kind` ("train" or "eval")."""
    if kind == "train":
        return TRAIN[name](task) if name == "token" else TRAIN[name]()
    return EVAL[name](task)
