"""GridState persistence — save/resume of in-flight relaxations.

The counterpart of ``epic_tpu.checkpoint``, with the same file format: one
.npz holding the six state fields under the same keys (``u``, ``locked``,
``iteration``, ``delta``, ``converged``, ``epsilon``), plus ``planner_meta``
and ``interpolation`` for a 2D planner session or ``volume_meta`` for a 3D
one. So a checkpoint crosses between the two packages in both directions,
and loads with plain NumPy.

Saving copies the state to the host once; loading places it on the
``device`` the caller names, with the saved bits.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from . import grid as G


def save(path: str | pathlib.Path, state: G.GridState) -> None:
    np.savez_compressed(path, **G.state_to_numpy(state))


def load(path: str | pathlib.Path, *, device: torch.device | str) -> G.GridState:
    """The state saved at ``path`` (by either package) on ``device``."""
    with np.load(path) as z:
        return G.state_from_numpy({k: z[k] for k in ("u", "locked", "iteration", "delta",
                                                     "converged", "epsilon")}, device=device)


def save_planner(path: str | pathlib.Path, planner) -> None:
    """Persist a whole planner session: grid state + service-plane config
    (world transforms, steps per update, pause flag, interpolation), so an
    anytime node survives a process restart mid-relaxation and resumes
    warm."""
    st = planner.state
    if st is None:
        raise ValueError("planner not initialized")
    cfg = planner.config
    np.savez_compressed(
        path,
        **G.state_to_numpy(st),
        planner_meta=np.asarray([
            cfg.resolution, cfg.origin_x, cfg.origin_y,
            float(cfg.steps_per_update), float(planner.paused),
        ]),
        interpolation=np.asarray(cfg.interpolation),
    )


def save_volume_planner(path: str | pathlib.Path, planner) -> None:
    """Persist a 3D planner session
    (:class:`epic_tpu_torch.planner3d.VolumePlanner`): volume state +
    transforms + pause flag, the 3D twin of :func:`save_planner`."""
    st = planner.state
    if st is None:
        raise ValueError("planner not initialized")
    cfg = planner.config
    np.savez_compressed(
        path,
        **G.state_to_numpy(st),
        volume_meta=np.asarray([
            cfg.resolution, cfg.origin_x, cfg.origin_y, cfg.origin_z,
            float(cfg.steps_per_update), float(planner.paused),
        ]),
    )


def _config(state: G.GridState, config, default_cls):
    """The restored session's config and state: a copy of ``config`` (never
    the caller's object) whose epsilon, when it differs from the default,
    replaces the snapshot's; else the snapshot's epsilon."""
    if config is None:
        return default_cls(epsilon=float(state.epsilon)), state
    cfg = dataclasses.replace(config)
    if cfg.epsilon != default_cls().epsilon:
        # An explicit override re-targets the resumed relaxation.
        eps = torch.tensor(cfg.epsilon, dtype=torch.float32, device=state.u.device)
        state = dataclasses.replace(state, epsilon=eps)
    else:
        cfg.epsilon = float(state.epsilon)
    return cfg, state


def load_planner(path: str | pathlib.Path, config=None, *, device: torch.device | str):
    """Restore a planner session saved by :func:`save_planner` on ``device``.

    ``config`` optionally overrides solver settings: its epsilon (when it
    differs from the default) replaces the snapshot's. Transforms,
    interpolation mode, steps_per_update and the pause flag always come from
    the snapshot. The caller's config object is never mutated (a copy is
    taken).
    """
    from .planner import Planner, PlannerConfig

    state = load(path, device=device)
    with np.load(path) as z:
        meta = z["planner_meta"]
        interpolation = str(z["interpolation"])
    cfg, state = _config(state, config, PlannerConfig)
    cfg.resolution = float(meta[0])
    cfg.origin_x = float(meta[1])
    cfg.origin_y = float(meta[2])
    cfg.steps_per_update = int(meta[3])
    cfg.interpolation = interpolation
    planner = Planner(cfg, device=device)
    planner.state = state
    planner.paused = bool(meta[4])
    return planner


def load_volume_planner(path: str | pathlib.Path, config=None, *,
                        device: torch.device | str):
    """Restore a 3D planner session saved by :func:`save_volume_planner` on
    ``device``. Same override contract as :func:`load_planner`."""
    from .planner3d import VolumePlanner, VolumePlannerConfig

    state = load(path, device=device)
    with np.load(path) as z:
        meta = z["volume_meta"]
    cfg, state = _config(state, config, VolumePlannerConfig)
    cfg.resolution = float(meta[0])
    cfg.origin_x = float(meta[1])
    cfg.origin_y = float(meta[2])
    cfg.origin_z = float(meta[3])
    cfg.steps_per_update = int(meta[4])
    planner = VolumePlanner(cfg, device=device)
    planner.state = state
    planner.paused = bool(meta[5])
    return planner
