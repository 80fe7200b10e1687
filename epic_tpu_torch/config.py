"""Typed configuration for the solver stack (SURVEY §5 "config/flag system").

The reference's configuration surface is ROS parameters + keyword defaults
scattered across launch files (epic_navigation_node_main.cpp:43-68,
launch/*.launch). Here it is one dataclass tree covering solver numerics,
kernel selection/tiling, mesh shape, and service endpoints. PlannerConfig
(epic_tpu_torch.planner) embeds SolverConfig semantics for the anytime node.

A copy of ``epic_tpu.config``, so that ``configs/*.yaml`` loads unchanged.
The kernel-selection fields ``backend``, ``kernel`` and ``tile_band`` are
kept for that reason only: the port chooses its kernels by device and grid
size, takes only ``backend="auto"`` (see :func:`check_backend`) and no TPU
band height. ``tile_depth`` is the port's own: the halo depth K of its tile
kernels.
"""

from __future__ import annotations

import dataclasses

from . import constants as C


@dataclasses.dataclass
class SolverConfig:
    """Numerics + kernel selection.

    ``tile_depth`` is K of the port's temporally blocked tile kernels
    (``csrc/tile2d.cu``, for 2D grids beyond the card's L2): the sweeps a
    tile runs per trip to memory, and the depth of its halo. It must be at
    least 1; whether a tile and its halo fit a block's shared memory is the
    card's to say, and the kernels' wrapper checks it before each launch
    (``solver.hopper_tile2d.check_depth``). ``tile_band`` must stay None: it
    names a TPU band height, which the port has no use for."""

    epsilon: float = C.DEFAULT_EPSILON_NODE
    stagger: int = C.DEFAULT_STAGGER
    max_iterations: int = 1_000_000
    # backend: the port takes only "auto" (the CUDA kernels for a tensor on
    # the card, the plain torch version for one on the CPU).
    backend: str = "auto"
    # kernel: the masked full-grid layout (the parity-packed half-grid
    # variant measured worse on v5e — lane shifts/selects cost more than the
    # saved logsumexps, docs/BENCH_NOTES.md — and was retired in round 3
    # with pallas_packed; "masked" is the only value).
    kernel: str = "masked"           # "masked"
    # tile_band: epic_tpu's row-band height for its beyond-VMEM kernels
    # (pallas_biggrid). The port's tiles are not row bands, so only None
    # is accepted. tile_depth: the temporal-blocking K of the port's tile
    # kernels (solver.hopper_tile2d): sweeps per trip to memory and the
    # halo's depth, for 2D grids beyond the card's L2. Consumed by the
    # Planner's ticks and solves on that route.
    tile_band: int | None = None
    tile_depth: int = 16
    # Opt-in coarse-to-fine warm start for blocking solves (solver.cascade).
    # Planner(EpicConfig) drops it, as epic_tpu's does (ROADMAP, known
    # divergences: R9): only PlannerConfig.cascade turns the cascade on.
    cascade: bool = False

    def __post_init__(self):
        check_backend(self.backend)
        if self.tile_band is not None:
            raise ValueError(
                f"tile_band={self.tile_band} names a TPU band height, which "
                "epic_tpu_torch does not use (its tile shape is fixed by "
                "measurement on the card); leave it None")
        if self.tile_depth < 1:
            raise ValueError(f"tile_depth must be >= 1, got {self.tile_depth}")


def check_backend(backend: str) -> None:
    """The port has one kernel route per device; any other backend name
    (the JAX package's "xla"/"pallas") is refused rather than ignored."""
    if backend != "auto":
        raise ValueError(
            f"backend {backend!r} is not supported by epic_tpu_torch; "
            "use 'auto'")


@dataclasses.dataclass
class MeshConfig:
    """Multi-device decomposition (epic_tpu_torch.parallel: the 2D and 3D
    meshes of MeshPlanner and MeshVolumePlanner)."""

    shape: tuple[int, int] | None = None   # None -> near-square over devices
    axis_names: tuple[str, str] = ("my", "mx")


@dataclasses.dataclass
class ServiceConfig:
    """Service-plane endpoints (epic_tpu_torch.services.server)."""

    host: str = "127.0.0.1"
    port: int = 7171
    steps_per_update: int = 50
    update_rate_hz: float = 10.0


@dataclasses.dataclass
class VizConfig:
    """Display profile — the declarative analog of the reference's rviz
    view config (rviz/default.rviz wired by
    launch/epic_navigation_node_umass.launch:26): what the demos and the
    interactive session render and how streamlines are walked. Consumed
    by the JAX package's ``tools/anytime_demo.py`` and ``epic_tpu.viz``."""

    show_field: bool = True          # False: draw over the original map
    interpolation: str = "bilinear"  # path walker mode ("reference" quirk-faithful)
    starts: int = 6                  # demo sample start points


@dataclasses.dataclass
class EpicConfig:
    """The full configuration tree. Consumed by :class:`epic_tpu_torch.
    planner.Planner` (pass it in place of a PlannerConfig) and the
    service-server CLI (``python -m epic_tpu_torch.services.server``).

    Serializable to/from YAML session files (``configs/*.yaml``) — the
    declarative analog of the reference's per-map launch tuning
    (launch/epic_navigation_node_umass.launch:8-23 carries map_name +
    steps_per_update/update_rate per map; here the same knobs live in a
    checked-in config file instead of code defaults)."""

    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    service: ServiceConfig = dataclasses.field(default_factory=ServiceConfig)
    viz: VizConfig = dataclasses.field(default_factory=VizConfig)
    # Startup map: a map_server YAML or PNG path. ``${VAR}`` env refs are
    # expanded at resolve time; relative paths resolve against the config
    # file's directory first, then maps.reference_map_path.
    map: str | None = None

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EpicConfig":
        d = dict(d)
        sections = {}
        for name, sub_cls in (("solver", SolverConfig), ("mesh", MeshConfig),
                              ("service", ServiceConfig),
                              ("viz", VizConfig)):
            sub = d.pop(name, None) or {}
            fields = {f.name for f in dataclasses.fields(sub_cls)}
            unknown = set(sub) - fields
            if unknown:
                raise ValueError(
                    f"unknown {name} config keys: {sorted(unknown)}")
            sections[name] = sub_cls(**sub)
        if sections["mesh"].shape is not None:
            sections["mesh"].shape = tuple(sections["mesh"].shape)
        sections["mesh"].axis_names = tuple(sections["mesh"].axis_names)
        map_path = d.pop("map", None)
        if d:
            raise ValueError(f"unknown config keys: {sorted(d)}")
        return cls(map=map_path, **sections)

    def save_yaml(self, path) -> None:
        import yaml

        d = self.to_dict()
        if d.get("map") is None:
            d.pop("map", None)
        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)

    @classmethod
    def load_yaml(cls, path) -> "EpicConfig":
        import pathlib

        import yaml

        path = pathlib.Path(path)
        with open(path) as f:
            d = yaml.safe_load(f) or {}
        cfg = cls.from_dict(d)
        cfg._config_dir = path.parent   # for relative map resolution
        cfg._config_path = path.resolve()
        return cfg

    def resolve_map_path(self):
        """Resolve :attr:`map` to an existing file path, or None.

        Order: env-var expansion, absolute path, path relative to the
        config file's directory, then the reference fixture search
        (:func:`epic_tpu_torch.maps.reference_map_path`). Raises
        FileNotFoundError for a configured map that resolves nowhere."""
        import os
        import pathlib

        if self.map is None:
            return None
        p = pathlib.Path(os.path.expandvars(self.map))
        if p.is_absolute():
            if p.exists():
                return p
        else:
            base = getattr(self, "_config_dir", pathlib.Path("."))
            cand = base / p
            # Guard the name collision: a session config whose ``map`` is
            # a bare name like "maze.yaml" must not resolve to the config
            # file ITSELF (both live in configs/).
            self_path = getattr(self, "_config_path", None)
            if cand.exists() and (self_path is None
                                  or cand.resolve() != self_path):
                return cand
            from . import maps

            ref = maps.reference_map_path(str(p)) or maps.reference_map_path(
                p.name)
            if ref is not None:
                return ref
        raise FileNotFoundError(f"configured map not found: {self.map}")
