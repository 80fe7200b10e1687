"""epic_tpu_torch's session config against epic_tpu's: where a config's
``map`` resolves (``EpicConfig.resolve_map_path``), the reference fixture
search (``maps.reference_map_path``) included."""

import pathlib
import types

import pytest

from epic_tpu import maps as JM
from epic_tpu.config import EpicConfig as JaxConfig
from epic_tpu_torch import maps as TM
from epic_tpu_torch.config import EpicConfig

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def _resolve(cls, path):
    """The resolved map path of the config at ``path``, or the exception
    type it raises."""
    try:
        return cls.load_yaml(path).resolve_map_path()
    except FileNotFoundError as e:
        return type(e)


def test_map_name_does_not_resolve_to_config_itself(tmp_path):
    """tests/test_config.py's case on the port: a session config whose
    ``map`` shares its own filename never resolves to itself."""
    p = tmp_path / "maze.yaml"
    p.write_text("map: maze.yaml\n")
    cfg = EpicConfig.load_yaml(p)
    try:
        r = cfg.resolve_map_path()  # may find the reference fixture
    except FileNotFoundError:
        r = None
    assert r is None or r.resolve() != p.resolve()
    # A config map name with no fixture anywhere raises cleanly.
    p3 = tmp_path / "nonesuch-xyz.yaml"
    p3.write_text("map: nonesuch-xyz.yaml\n")
    with pytest.raises(FileNotFoundError):
        EpicConfig.load_yaml(p3).resolve_map_path()
    # With a distinct real file of that name present, it resolves to it.
    sub = tmp_path / "maps"
    sub.mkdir()
    (sub / "maze.yaml").write_text("image: maze.png\n")
    p2 = tmp_path / "session.yaml"
    p2.write_text("map: maps/maze.yaml\n")
    assert EpicConfig.load_yaml(p2).resolve_map_path() == sub / "maze.yaml"


def test_map_found_in_a_reference_fixture_directory(tmp_path, monkeypatch):
    """A map that is not beside its config comes from the reference's
    fixture directories under $EPIC_REFERENCE_ROOT, searched in order, by
    its path and then by its bare name; the config file itself is never the
    answer, and with the variable unset nothing is searched."""
    ref = tmp_path / "reference"
    monkeypatch.setenv("EPIC_REFERENCE_ROOT", str(ref))
    for d in TM.REFERENCE_MAP_DIRS:
        (ref / d).mkdir(parents=True)
    (ref / "libepic/tests/maps/maze.yaml").write_text("image: maze.png\n")
    (ref / "libepic/tests/maps/umass.png").write_bytes(b"")
    (ref / "libepic/tests/batch/umass.png").write_bytes(b"")
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    own = cfg_dir / "maze.yaml"
    own.write_text("map: maze.yaml\n")
    assert EpicConfig.load_yaml(own).resolve_map_path() == ref / "libepic/tests/maps/maze.yaml"
    # The batch directory comes before tests/maps; a sub-path falls back to its name.
    for name in ("umass.png", "sub/umass.png"):
        p = cfg_dir / "umass.yaml"
        p.write_text(f"map: {name}\n")
        assert EpicConfig.load_yaml(p).resolve_map_path() == ref / "libepic/tests/batch/umass.png"
    (ref / "maps/umass.png").write_bytes(b"")
    assert EpicConfig.load_yaml(p).resolve_map_path() == ref / "maps/umass.png"
    assert TM.reference_map_path("nonesuch-xyz.png") is None
    p.write_text("map: nonesuch-xyz.png\n")
    with pytest.raises(FileNotFoundError):
        EpicConfig.load_yaml(p).resolve_map_path()
    monkeypatch.delenv("EPIC_REFERENCE_ROOT")
    assert TM.reference_map_path("maze.yaml") is None
    with pytest.raises(FileNotFoundError):
        EpicConfig.load_yaml(own).resolve_map_path()


def _share_reference_tree(tmp_path, monkeypatch):
    """Point epic_tpu's fixture search and the port's at one tree under
    ``tmp_path`` and return its root. epic_tpu's candidate directories are
    fixed absolute paths: each is rebuilt below ``tmp_path``, and the root
    they share, with the port's directories in the port's order beneath it,
    is read off them, so this also holds the two candidate lists equal."""
    built = []

    def reroot(*parts):
        q = pathlib.Path(*parts)
        if not q.is_absolute():
            return q
        built.append(q)
        return tmp_path / q.relative_to(q.anchor)

    monkeypatch.setattr(JM, "pathlib", types.SimpleNamespace(Path=reroot))
    assert JM.reference_map_path("probe.png") is None
    dirs = [pathlib.PurePosixPath(d).parts for d in TM.REFERENCE_MAP_DIRS]
    assert len(built) == len(dirs)
    roots = set()
    for q, d in zip(built, dirs):
        assert q.parts[-len(d):] == d, q
        roots.add(q.parents[len(d) - 1])
    (root,) = roots
    ref = tmp_path / root.relative_to(root.anchor)
    monkeypatch.setenv("EPIC_REFERENCE_ROOT", str(ref))
    return ref


def test_resolve_map_path_matches_epic_tpu(tmp_path, monkeypatch):
    """The port and epic_tpu resolve the same configs to the same map (or
    both raise), both searching one reference tree: the shipped session
    configs (found there), a map beside its config, a config that names
    itself, a sub-path found by its name, a name in two fixture directories,
    a missing map, and an absolute path."""
    ref = _share_reference_tree(tmp_path / "mnt", monkeypatch)
    for d in TM.REFERENCE_MAP_DIRS:
        (ref / d).mkdir(parents=True)
    (ref / "libepic/tests/maps/maze.yaml").write_text("image: maze.png\n")
    for d in ("maps", "libepic/tests/batch"):
        (ref / d / "umass.yaml").write_text("image: umass.png\n")
    (ref / "libepic/tests/batch/b.png").write_bytes(b"")
    (ref / "libepic/tests/maps/b.png").write_bytes(b"")
    (tmp_path / "m.png").write_bytes(b"")
    cases = {"beside.yaml": "map: m.png\n", "maze.yaml": "map: maze.yaml\n",
             "sub.yaml": "map: sub/maze.yaml\n", "two.yaml": "map: b.png\n",
             "missing.yaml": "map: nonesuch-xyz.png\n",
             "absolute.yaml": f"map: {tmp_path / 'm.png'}\n", "none.yaml": "solver: {}\n"}
    paths = sorted(CONFIGS.glob("*.yaml"))
    for name, text in cases.items():
        (tmp_path / name).write_text(text)
        paths.append(tmp_path / name)
    answers = [(_resolve(EpicConfig, p), _resolve(JaxConfig, p)) for p in paths]
    for p, (ours, theirs) in zip(paths, answers):
        assert ours == theirs, p.name
    found = {p.name: ours for p, (ours, _) in zip(paths, answers)}
    assert [found[p.name] for p in sorted(CONFIGS.glob("*.yaml"))] == [
        ref / "libepic/tests/maps/maze.yaml", ref / "maps/umass.yaml"]
    assert found["two.yaml"] == ref / "libepic/tests/batch/b.png"
    assert found["sub.yaml"] == ref / "libepic/tests/maps/maze.yaml"
    assert found["beside.yaml"] == tmp_path / "m.png"
    assert found["missing.yaml"] is FileNotFoundError
