"""The port's offline nuScenes preparation against the JAX package's.

On ``test_converter.fake_devkit``'s world (a handcrafted devkit injected
into ``sys.modules``), the port's ``data/nuscenes_converter`` writes the
same infos pkls as the JAX package's, dict by dict and array by array, and
the port's ``tools/create_data``, ``create_range_images`` and
``create_elevation`` write the same files as the root scripts, bit for
bit.  The walk over the samples also needs the devkit's
``LidarPointCloud``, each scene's ``first_sample_token`` and the devkit's
``dataroot``: the fixture adds them to the fake world here.
"""

import importlib.util
import json
import os
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from efficient_multimodal_perception_tpu.data import (
    nuscenes_converter as jax_converter,
)
from efficient_multimodal_perception_tpu_torch.data import nuscenes_converter
from efficient_multimodal_perception_tpu_torch.tools import (
    create_data,
    create_elevation,
    create_range_images,
)
from test_converter import fake_devkit  # noqa: F401
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

ROOT_TOOLS = Path(__file__).resolve().parent.parent / "tools"


def assert_same(got, want, where="infos"):
    """Equal nested containers: numpy arrays by ``np.array_equal`` (and
    dtype), everything else by ``==``."""
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got, want), where
    else:
        assert got == want, where


def _pickles(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = pickle.load(f)
    return out


class FakeLidarPointCloud:
    """The devkit's ``LidarPointCloud.from_file``: float32 rows of 5, the
    first 4 kept, points ``(4, N)``."""

    def __init__(self, points):
        self.points = points

    @classmethod
    def from_file(cls, path):
        scan = np.fromfile(path, dtype=np.float32)
        return cls(scan.reshape((-1, 5))[:, :4].T)


@pytest.fixture()
def world(fake_devkit):  # noqa: F811
    """The fake devkit's world, walkable by ``lidar_clouds``."""
    root = fake_devkit
    nusc = sys.modules["nuscenes.nuscenes"].NuScenes("v1.0-trainval", root)
    nusc.dataroot = root
    for scene in nusc.scene:
        scene["first_sample_token"] = next(
            s["token"] for s in nusc.sample
            if s["scene_token"] == scene["token"])
    classes = types.ModuleType("nuscenes.utils.data_classes")
    classes.LidarPointCloud = FakeLidarPointCloud
    saved = sys.modules.get("nuscenes.utils.data_classes")
    sys.modules["nuscenes.utils.data_classes"] = classes
    try:
        yield root
    finally:
        if saved is None:
            sys.modules.pop("nuscenes.utils.data_classes", None)
        else:
            sys.modules["nuscenes.utils.data_classes"] = saved


def _out(root, name):
    path = os.path.join(root, name)
    os.makedirs(path)
    return path


@pytest.mark.parametrize("max_sweeps", [0, 2])
def test_infos_match_jax(world, max_sweeps):
    want = jax_converter.create_nuscenes_infos(
        world, _out(world, "jax"), max_sweeps=max_sweeps)
    got = nuscenes_converter.create_nuscenes_infos(
        world, _out(world, "port"), max_sweeps=max_sweeps)
    assert_same(got, want)
    assert sum(len(info["sweeps"]) for info in got[0]) == max_sweeps
    files = _pickles(os.path.join(world, "port"))
    assert list(files) == ["nuscenes_infos_train.pkl",
                           "nuscenes_infos_val.pkl"]
    assert_same(files, _pickles(os.path.join(world, "jax")))


def test_occ_infos_match_jax(world):
    occ_dir = _out(world, "occ3d")
    with open(os.path.join(occ_dir, "annotations.json"), "w") as f:
        json.dump({"scene_infos": {
            "scene-0001": {"tok0": {"gt_path": "gts/scene-0001/tok0"}},
            "scene-0002": {"tok1": {}}}}, f)
    jax_converter.create_nuscenes_occ_infos(world, occ_dir,
                                            _out(world, "jax"), max_sweeps=1)
    nuscenes_converter.create_nuscenes_occ_infos(
        world, occ_dir, _out(world, "port"), max_sweeps=1)
    files = _pickles(os.path.join(world, "port"))
    assert "nuscenes_infos_temporal_train.pkl" in files
    temporal = files["nuscenes_infos_temporal_train.pkl"]["infos"][0]
    assert temporal["occ_gt_path"] == "gts/scene-0001/tok0"
    assert_same(files, _pickles(os.path.join(world, "jax")))


def _root_main(name):
    """The root script ``tools/<name>.py``'s ``main``."""
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", ROOT_TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _files(top):
    """``{relative path: bytes}`` of every file under ``top``."""
    return {str(p.relative_to(top)): p.read_bytes()
            for p in sorted(Path(top).rglob("*")) if p.is_file()}


def _run_root(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    _root_main(name)()


TOOLS = {  # the arguments of each tool, the same for both sides
    "create_data": (create_data, ["nuscenes", "--root-path", "{root}",
                                  "--out-dir", "{out}", "--max-sweeps", "2"]),
    "create_range_images": (create_range_images, ["--dataroot", "{root}"]),
    "create_elevation": (create_elevation, ["--dataroot", "{root}",
                                            "--save-path", "{out}"]),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_create_tool_matches_root_script(world, monkeypatch, capsys, name):
    """The port's tool and the root script, on the same world and with the
    same arguments, write the same files byte for byte and print the same
    lines (the root script's files are read and removed before the port's
    tool runs)."""
    module, args = TOOLS[name]
    out = os.path.join(world, "out")
    argv = [a.format(root=world, out=out) for a in args]
    top = (os.path.join(world, "samples", "RANGE_FULL")
           if name == "create_range_images" else out)
    written = {}
    for side in ("root", "port"):
        os.makedirs(out, exist_ok=True)
        if side == "root":
            _run_root(monkeypatch, name, argv)
        else:
            assert module.main(argv) == 0
        written[side] = (_files(top), capsys.readouterr().out)
        for p in Path(top).rglob("*"):
            if p.is_file():
                p.unlink()
    files, printed = written["port"]
    assert len(files) == 2 and printed, (sorted(files), printed)
    assert written["port"] == written["root"]
