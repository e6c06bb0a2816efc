"""Config system: frozen dataclasses + YAML + dotted CLI overrides
(counterpart of mupe_tpu/utils/config.py).

Task/algo configs are the frozen dataclasses defined next to their
components, YAML files overlay field values, and CLI args use
`section.field=value` syntax like Hydra's.  PyYAML is imported only by
`load_yaml_overrides`.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, TypeVar

T = TypeVar("T")


def _coerce(value: str, target_type) -> Any:
    if value.lower() in ("null", "none"):
        return None
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if target_type in (tuple, list) or str(target_type).startswith(
        ("typing.Tuple", "tuple")
    ):
        return tuple(json.loads(value))
    if value.lower() in ("null", "none"):
        return None
    # Optional[Tuple[...]] fields default to None, so the declared type is
    # unavailable — sniff bracketed literals (env.dr_mass_scale='[0.8,1.2]')
    if value[:1] == "[":
        try:
            return tuple(json.loads(value))
        except json.JSONDecodeError:
            pass
    return value


def _optional_inner(cls: type, field_name: str):
    """The non-None member of an Optional[...] field annotation, resolved
    properly (typing.get_type_hints + get_args) instead of substring
    sniffing.  Containers (Tuple/List/...) map to `tuple` (the bracketed
    JSON-literal coercion path); unresolvable annotations return None."""
    import typing

    try:
        hint = typing.get_type_hints(cls).get(field_name)
    except Exception:
        return None
    if hint is None:
        return None
    non_none = [
        a for a in typing.get_args(hint) if a is not type(None)
    ] or [hint]
    inner = non_none[0]
    origin = typing.get_origin(inner)
    if origin in (tuple, list):
        return tuple
    return inner if isinstance(inner, type) else None


def apply_overrides(cfg: T, overrides: Dict[str, Any]) -> T:
    """Overlay {field: value} onto a frozen dataclass, coercing strings."""
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    updates = {}
    for k, v in overrides.items():
        if k not in fields:
            raise KeyError(
                f"unknown config field {k!r} for {type(cfg).__name__}; "
                f"valid: {sorted(fields)}"
            )
        if isinstance(v, str):
            f = fields[k]
            base = f.type if isinstance(f.type, type) else type(getattr(cfg, k))
            # Optional[...] fields defaulting to None leave `base` as
            # NoneType; recover the non-None member by resolving the
            # (stringified, `from __future__ import annotations`)
            # annotation with typing.get_type_hints
            if base is type(None) and not isinstance(f.type, type):
                inner = _optional_inner(type(cfg), k)
                if inner is not None:
                    base = inner
            try:
                v = _coerce(v, base)
            except (ValueError, json.JSONDecodeError):
                pass
        updates[k] = v
    return dataclasses.replace(cfg, **updates)


def load_yaml_overrides(path: str | Path) -> Dict[str, Dict[str, Any]]:
    """Load a YAML file of {section: {field: value}} overlays."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return data


def parse_cli(
    argv: Sequence[str],
) -> tuple[Dict[str, Dict[str, Any]], Dict[str, Any]]:
    """Parse `section.field=value` args (Hydra-style) plus bare
    `key=value` top-level flags.  Returns (sections, top_level)."""
    sections: Dict[str, Dict[str, Any]] = {}
    top: Dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        if "." in key:
            sec, field = key.split(".", 1)
            sections.setdefault(sec, {})[field] = value
        else:
            top[key] = value
    return sections, top


@dataclasses.dataclass(frozen=True)
class RunCfg:
    """Top-level run settings (reference cfg/train.yaml)."""

    task: str = "HideAndSeek"
    algo: str = "mappo"
    seed: int = 0
    total_frames: int = 10_000_000_000
    max_iters: int = -1
    eval_interval: int = -1
    save_interval: int = 100
    log_interval: int = 10
    run_dir: str = "runs"
    run_name: Optional[str] = None
    model_dir: Optional[str] = None   # warm-start: learner state only
    resume_dir: Optional[str] = None  # exact resume: full carry (ckpt/full)
    wandb_mode: str = "disabled"     # disabled | online | offline
    wandb_project: str = "mupe_tpu"
    wandb_entity: Optional[str] = None
    # eval-video sink (reference eval.py:245-251 wandb.Video): GIF path;
    # empty disables rendering
    video: str = ""
    video_env_index: int = 0
    # observability / failure detection (not ported yet: `train` raises)
    guard_nan: bool = False   # skip non-finite updates (1 sync/iter)
    profile_dir: str = ""     # profiler trace of iters 1-3 → this dir
