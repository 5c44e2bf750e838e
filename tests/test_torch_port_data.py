"""The port's data layer against the JAX package's, on the CPU.

Both packages read the same files:

- ``make_fake_tree`` (``tests/test_nuscenes_loader.py``): three samples
  of 500 points, occupancy and elevation files;
- the converter's world (``tests/test_converter.py``: ``fake_devkit``,
  ``prepare_fixture_dataset``), whose samples carry a two-sweep chain;
- a world from the port's own writer (``tools/fixture_world.py``):
  full-size JPEGs and a 34000-point keyframe.

``NuScenesDataset.sample`` and ``batch`` and ``epoch_batches`` must give
the JAX package's arrays bit for bit (``np.array_equal``, same dtype):
train and val, epochs 0 and 1, clouds under and over the point budget
(the train subsample and the val stride), ``rand_flip`` on and off,
sweeps drawn and not, one and four loader threads.  Every copied
transform, wrapper, prep, native and utils function, and
``label_points_with_masks``, must equal its JAX counterpart on the same
seeded inputs; every config's data block must equal JAX's.
"""

import copy
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficient_multimodal_perception_tpu.configs import (
    get_config as jax_get_config,
)
from efficient_multimodal_perception_tpu.core.geometry import CameraAug as JAug
from efficient_multimodal_perception_tpu.data import native as jnative
from efficient_multimodal_perception_tpu.data import nuscenes as jnus
from efficient_multimodal_perception_tpu.data import prep as jprep
from efficient_multimodal_perception_tpu.data import transforms as jtf
from efficient_multimodal_perception_tpu.data import utils as jutils
from efficient_multimodal_perception_tpu.data import wrappers as jwrap
from efficient_multimodal_perception_tpu.data import sam_masks as jsam
from efficient_multimodal_perception_tpu.data.batch import Batch as JBatch
from efficient_multimodal_perception_tpu.parallel.mesh import (
    process_local_indices as jlocal,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.data import (
    native,
    prep,
    sam_masks,
)
from efficient_multimodal_perception_tpu_torch.data import nuscenes as nus
from efficient_multimodal_perception_tpu_torch.data import transforms as tf
from efficient_multimodal_perception_tpu_torch.data import utils, wrappers
from efficient_multimodal_perception_tpu_torch.data.batch import Batch
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.tools.fixture_world import (
    write_world,
)
from test_converter import fake_devkit, prepare_fixture_dataset  # noqa: F401
from test_nuscenes_loader import make_fake_tree
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401


def data_cfg(root, **kw):
    """The shipped data block (every loader flag on) rooted at ``root``."""
    cfg = get_config("tiny_occ_run")["data"]
    cfg.update(data_root=root, load_points=True, load_elev=True, workers=1)
    cfg.update(kw)
    return cfg


def assert_same(want, got, what):
    """JAX-side numpy array vs the port's array or tensor: same dtype,
    same bits."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert np.array_equal(got, want), what


def assert_batches_equal(jb, pb):
    assert isinstance(pb, Batch)
    for f in dataclasses.fields(Batch):
        want, got = getattr(jb, f.name), getattr(pb, f.name)
        if f.name == "cam_aug":
            for k in ("resize", "crop", "flip"):
                assert_same(getattr(want, k), getattr(got, k), k)
        elif want is None:
            assert got is None, f.name
        else:
            assert got.device.type == "cpu"
            assert_same(want, got, f.name)


def assert_samples_equal(js, ps):
    assert sorted(js) == sorted(ps)
    for k in js:
        assert_same(js[k], ps[k], k)


def loaders(cfg, split, seed=0, epoch=0):
    """``(JAX dataset, port dataset)`` on one config, at ``epoch``."""
    jd = jnus.NuScenesDataset(copy.deepcopy(cfg), split, seed=seed)
    pd = nus.NuScenesDataset(copy.deepcopy(cfg), split, seed=seed)
    jd.set_epoch(epoch)
    pd.set_epoch(epoch)
    return jd, pd


def check_loaders(cfg, split, epoch, seed=0):
    """``sample(0)`` and the batch of every sample, both packages."""
    jd, pd = loaders(cfg, split, seed, epoch)
    assert len(jd) == len(pd)
    assert_samples_equal(jd.sample(0), pd.sample(0))
    idx = list(range(len(pd)))
    pb = pd.batch(idx)
    assert (pb.batch_size, pb.num_cams) == (len(idx), cfg["num_cams"])
    assert_batches_equal(jd.batch(idx), pb)
    return pb


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    """``make_fake_tree`` with ``occ_filename`` patched into both infos."""
    root = make_fake_tree(str(tmp_path_factory.mktemp("fake_nusc")))
    for split in ("train", "val"):
        prep.add_occ_filenames(
            os.path.join(root, f"nuscenes_infos_{split}.pkl"))
    return root


@pytest.fixture(scope="module")
def writer_root(tmp_path_factory):
    """Two samples (one train, one val) of the port's world writer."""
    root = str(tmp_path_factory.mktemp("writer_world"))
    world = write_world(root, n_train=1, n_val=1, seed=3)
    assert len(world["train"]) == len(world["val"]) == 1
    return root


# split, epoch, point budget (500 points on disk), rand_flip
FAKE_CASES = [
    ("train", 0, 1024, True),   # under budget
    ("train", 1, 256, True),    # over: the train subsample
    ("val", 0, 256, True),      # over: the val stride
    ("val", 1, 1024, True),
    ("train", 0, 256, False),   # no flip draw
]


@pytest.mark.parametrize("split,epoch,budget,flip", FAKE_CASES)
def test_loader_matches_jax_on_fake_tree(fake_root, split, epoch, budget,
                                         flip):
    cfg = data_cfg(fake_root, point_budget=budget, rand_flip=flip)
    pb = check_loaders(cfg, split, epoch, seed=5)
    n_valid = pb.points_valid.sum(1)
    assert n_valid.tolist() == [min(500, budget)] * 3
    if split == "train" and flip:
        assert bool(pb.cam_aug.flip.any())  # flips drawn and applied
    if not flip or split == "val":
        assert not bool(pb.cam_aug.flip.any())


@pytest.mark.parametrize("sweeps_num,budget", [(2, 1024), (2, 4096),
                                               (1, 1024)])
def test_loader_matches_jax_with_sweeps(fake_devkit, sweeps_num,  # noqa: F811
                                        budget):
    """The converter's world: 600 keyframe points and a chain of two
    400-point sweeps (sweeps_num 1 draws which sweep in training)."""
    root = fake_devkit
    prepare_fixture_dataset(root, max_sweeps=2)
    cfg = data_cfg(root, sweeps_num=sweeps_num, point_budget=budget)
    # a val sample draws nothing: its epoch does not matter
    for split, epoch in (("train", 0), ("train", 1), ("val", 0)):
        pb = check_loaders(cfg, split, epoch)
        want = min(600 + 400 * sweeps_num, budget)
        assert pb.points_valid.sum().item() == want


@pytest.mark.parametrize("split", ["train", "val"])
def test_loader_matches_jax_on_writer_world(writer_root, split):
    """Full-size frames (1600 x 900 JPEGs, 34000 points under the
    36864-point budget, 30000 occupancy rows) from the port's writer."""
    cfg = copy.deepcopy(get_config("point_triplane_occ")["data"])
    cfg.update(data_root=writer_root, load_elev=True)
    for epoch in (0, 1):
        pb = check_loaders(cfg, split, epoch)
    assert pb.img.shape == (1, 6, 256, 512, 3)
    assert pb.points_valid.sum().item() == 34000
    labels = set(np.unique(pb.occupancy.numpy()).tolist())
    assert labels == {0, 1, 2, 3, 4, 255}


@pytest.mark.parametrize("workers", [1, 4])
def test_epoch_batches_match_jax(fake_root, workers):
    """Two epochs (seeds 7, 8: the shuffle and the dataset's epoch), of
    batches of 1 and of 2, in order, equal to JAX's."""
    cfg = data_cfg(fake_root, point_budget=256, workers=workers)
    jd, pd = loaders(cfg, "train", seed=2)
    for seed, bs in ((7, 1), (8, 2)):
        want = list(jnus.epoch_batches(jd, bs, seed=seed))
        got = list(nus.epoch_batches(pd, bs, seed=seed))
        assert len(got) == len(want) == 3 // bs
        assert pd.epoch == jd.epoch == seed
        for jb, pb in zip(want, got):
            assert_batches_equal(jb, pb)


def test_process_local_indices_match_jax():
    order = np.random.default_rng(0).permutation(24)
    for step in range(3):
        for count in (1, 2, 4):
            for rank in range(count):
                assert_same(jlocal(order, 8, step, rank, count),
                            nus.process_local_indices(order, 8, step, rank,
                                                      count), (step, rank))
    with pytest.raises(ValueError, match="not divisible"):
        nus.process_local_indices(order, 6, 0, 0, 4)


# ---------------------------------------------------------------------------
# the copied modules, one case each

def _cloud(seed, n=300, d=5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, (n, d)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4, 4, n)
    return pts


def _boxes_sample(seed):
    rng = np.random.default_rng(seed + 100)
    boxes = np.concatenate([rng.uniform(-45, 45, (12, 3)),
                            rng.uniform(1, 4, (12, 3)),
                            rng.uniform(-3, 3, (12, 1)),
                            rng.uniform(-2, 2, (12, 2))], 1)
    return {"points": _cloud(seed), "gt_bboxes_3d": boxes.astype(np.float32),
            "gt_labels_3d": rng.integers(0, 10, 12)}


def _apply_transform(mod, name, kwargs, use_rng, seed=0):
    s = _boxes_sample(seed)
    args = (np.random.default_rng(seed),) if use_rng else ()
    return getattr(mod, name)(s, *args, **kwargs)


def _transform_case(name, kwargs=None, use_rng=True):
    def run(m):
        return _apply_transform(m, name, kwargs or {}, use_rng)
    return run


def _depth(m):
    pts = _cloud(1)
    l2c = np.eye(4)
    l2c[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    intr = np.eye(4)
    intr[:3, :3] = [[400, 0, 256], [0, 400, 128], [0, 0, 1]]
    return m.points_to_image_depth(pts, intr @ l2c, l2c, (256, 512))


def _tta(m):
    pr = functools.partial(m.points_range_filter,
                           pc_range=(-30, -30, -3, 30, 30, 3))
    return m.multi_scale_flip_aug_3d(
        _boxes_sample(2), transforms=(pr,), img_scale=[(800, 450)],
        pts_scale_ratio=[1.0, 1.1], flip=True,
        flip_direction=["horizontal"], pcd_horizontal_flip=True,
        pcd_vertical_flip=True)


class _StubDataset:
    """``sample`` / ``batch`` over seeded synthetic arrays (one sample an
    index), as a JAX or a port ``Batch``; ``get_cat_ids`` for CBGS."""

    num_classes = 4

    def __init__(self, jax_side, offset=0, n=5):
        self.jax_side, self.offset, self.n = jax_side, offset, n

    def __len__(self):
        return self.n

    def get_cat_ids(self, i):
        return {(i * 7 + self.offset) % 4, (i * 3) % 4} if i % 3 else {0}

    def sample(self, i):
        return {"index": self.offset + i}

    def batch(self, idx):
        arrs = [synthetic_arrays(1, point_budget=64, image_hw=(8, 16),
                                 seed=self.offset + i) for i in idx]
        arrs = {k: np.concatenate([a[k] for a in arrs]) for k in arrs[0]}
        if not self.jax_side:
            return arrays_to_batch(arrs)
        return JBatch(
            img=arrs["img"], range_image=arrs["range_image"],
            range_points=arrs["range_points"], lidar2img=arrs["lidar2img"],
            cam_aug=JAug(arrs["cam_resize"], arrs["cam_crop"],
                         arrs["cam_flip"]),
            points=arrs["points"], points_valid=arrs["points_valid"])


def _wrapper_case(kind):
    def run(m):
        jax_side = m is jwrap
        if kind == "repeat":
            d = m.RepeatDataset(_StubDataset(jax_side), 3)
            return len(d), d.sample(13), d.batch([4, 5, 11])
        if kind == "concat":
            d = m.ConcatDataset([_StubDataset(jax_side, 0, 3),
                                 _StubDataset(jax_side, 10, 4)])
            # within one dataset, then across the boundary (occupancy
            # and the elevation fields are None and stay None)
            return (len(d), d.sample(5), d.batch([3, 4]), d.batch([1, 2, 3]),
                    d.batch([0, 3]))
        d = m.CBGSDataset(_StubDataset(jax_side, 3, 9), seed=4)
        return len(d), d.sample_indices, d.sample(2), d.batch([0, 2])
    return run


def _prep_case(kind):
    def run(m):
        pts = _cloud(3, n=4000, d=4)
        if kind == "range":
            return m.make_range_image(pts)
        return m.make_elevation(pts)
    return run


def _add_occ(m, tmp_path):
    src = tmp_path / "infos.pkl"
    import pickle

    with open(src, "wb") as f:
        pickle.dump({"infos": [{"lidar_path": "samples/LIDAR_TOP/a.pcd.bin"},
                               {"lidar_path": "b.bin"}]}, f)
    out = m.add_occ_filenames(str(src), str(tmp_path / f"{m.__name__}.pkl"))
    with open(out, "rb") as f:
        return pickle.load(f)


def _native_case(kind):
    def run(m):
        rng = np.random.default_rng(4)
        if kind == "range":
            return m.range_projection_native(_cloud(4, n=5000, d=4))
        if kind == "occ":
            sp = np.stack([rng.integers(0, 200, 3000),
                           rng.integers(0, 200, 3000),
                           rng.integers(0, 16, 3000),
                           rng.integers(0, 17, 3000)], 1)
            return m.occ_densify_native(sp)
        return m.elevation_raster_native(_cloud(5, n=5000, d=4))
    return run


PIPELINE = [
    {"type": "LoadMultiViewImageFromFiles"},
    {"type": "LoadPointsFromFile", "load_dim": 11},
    {"type": "ImageAug3D"},
    {"type": "MultiScaleFlipAug3D",
     "transforms": [{"type": "LoadOccGTFromFile"}, {"type": "PointShuffle"},
                    {"type": "MultiScaleFlipAug3D",
                     "transforms": [{"type": "LoadElevGTFromFile"}]}]},
    {"type": "ImageNormalize"},
    {"type": "Collect3D"},
]


def _label(m):
    rng = np.random.default_rng(6)
    pts = rng.uniform(-20, 20, (2000, 3)).astype(np.float32)
    l2c = np.eye(4)
    l2c[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    intr = np.eye(4)
    intr[:3, :3] = [[100, 0, 64], [0, 100, 32], [0, 0, 1]]
    masks = [{"segmentation": rng.random((64, 128)) < p}
             for p in (0.3, 0.5, 0.2)]
    return m.label_points_with_masks(pts, intr @ l2c, (64, 128), masks)


COPIED = {
    # the eight transforms
    "global_rot_scale_trans": (jtf, tf, _transform_case(
        "global_rot_scale_trans", {"translation_std": (0.2, 0.2, 0.1)})),
    "random_flip_3d": (jtf, tf, _transform_case(
        "random_flip_3d", {"flip_ratio_bev_horizontal": 0.9,
                           "flip_ratio_bev_vertical": 0.9})),
    "point_shuffle": (jtf, tf, _transform_case("point_shuffle")),
    "points_range_filter": (jtf, tf, _transform_case(
        "points_range_filter", {"pc_range": (-25, -25, -3, 25, 25, 3)},
        use_rng=False)),
    "object_range_filter": (jtf, tf, _transform_case(
        "object_range_filter", {"pc_range": (-25, -25, -3, 25, 25, 3)},
        use_rng=False)),
    "object_name_filter": (jtf, tf, _transform_case(
        "object_name_filter", {"keep_labels": (1, 3, 5)}, use_rng=False)),
    "points_to_image_depth": (jtf, tf, _depth),
    "multi_scale_flip_aug_3d": (jtf, tf, _tta),
    # the three wrappers
    "RepeatDataset": (jwrap, wrappers, _wrapper_case("repeat")),
    "ConcatDataset": (jwrap, wrappers, _wrapper_case("concat")),
    "CBGSDataset": (jwrap, wrappers, _wrapper_case("cbgs")),
    # the three prep functions
    "make_range_image": (jprep, prep, _prep_case("range")),
    "make_elevation": (jprep, prep, _prep_case("elevation")),
    "add_occ_filenames": (jprep, prep, None),
    # the three native bindings
    "range_projection_native": (jnative, native, _native_case("range")),
    "occ_densify_native": (jnative, native, _native_case("occ")),
    "elevation_raster_native": (jnative, native, _native_case("elev")),
    # the two loading-pipeline helpers, and the result unwrapper
    "is_loading_function": (jutils, utils, lambda m: [
        m.is_loading_function(t) for t in PIPELINE
        + PIPELINE[3]["transforms"]]),
    "get_loading_pipeline": (jutils, utils,
                             lambda m: m.get_loading_pipeline(PIPELINE)),
    "extract_result_dict": (jutils, utils, lambda m: [
        m.extract_result_dict(r, k) for r, k in [
            (None, "x"), ({"y": 1}, "x"), ({"x": []}, "x"),
            ({"x": (np.arange(3.0), 5)}, "x"),
            ({"x": [jnp.arange(4, dtype=jnp.int32) if m is jutils
                    else torch.arange(4, dtype=torch.int32)]}, "x")]]),
    # SAM labelling
    "label_points_with_masks": (jsam, sam_masks, _label),
}


def _assert_tree_equal(want, got, path="out"):
    if isinstance(want, JBatch):
        assert_batches_equal(want, got)
    elif isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            _assert_tree_equal(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_tree_equal(w, g, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and not isinstance(
            want, (np.bool_,)) or type(want).__module__.startswith("jax"):
        assert_same(want, got, path)
    else:
        assert want == got and type(want) is type(got), (path, want, got)


@pytest.mark.parametrize("name", list(COPIED))
def test_copied_module_matches_jax(name, tmp_path):
    jmod, pmod, run = COPIED[name]
    if name == "add_occ_filenames":
        want, got = _add_occ(jmod, tmp_path), _add_occ(pmod, tmp_path)
    else:
        want, got = run(jmod), run(pmod)
    _assert_tree_equal(want, got)


def test_native_library_runs():
    """The repository's library loads here, so the bindings above ran the
    C++ functions, not the numpy fallback."""
    assert native.load_library() is not None


@pytest.mark.parametrize("name", ["nuscenes_range", "triplane_range_cam",
                                  "triplane_surf_sam", "triplane_occ",
                                  "triplane_elev", "point_triplane",
                                  "point_triplane_occ", "tiny_occ_run"])
def test_config_data_blocks_match_jax(name):
    """Each config's whole data block is JAX's (``data_nuscenes`` with
    that config's loader flags)."""
    if name == "tiny_occ_run":
        from efficient_multimodal_perception_tpu.configs.tiny_occ_run import (
            get_config as jax_tiny_occ_run)
        want = jax_tiny_occ_run()
    else:
        want = jax_get_config(name)
    assert get_config(name)["data"] == want["data"]
    if name == "tiny_occ_run":
        assert get_config(name)["model"] == want["model"]
