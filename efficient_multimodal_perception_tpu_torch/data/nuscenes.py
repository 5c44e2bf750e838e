"""nuScenes dataset: the infos reader and the static-shape sample pipeline
(copy of the JAX package's ``data/nuscenes.py``; batches are host torch
tensors).

* The infos pkl schema is the converter's; cameras are read in the
  infos' dict order, lidar2image = intrinsics4x4 @ lidar2camera, the
  info list is sorted by timestamp and cut by a fractional
  ``load_interval``.
* One function per sample does what the reference's pipeline
  transforms do: the multi-view images with ImageAug3D's resize, crop
  and flip and ImageNet normalisation (Pillow, bicubic), the range
  image, the 11-dim points (with sweeps), the 16 -> 5-class occupancy
  remap and densify, the elevation map.
* Ragged points are padded to ``point_budget`` with a validity mask, the
  static-shape contract of :class:`Batch`.

Every random draw comes from ``np.random.default_rng([seed, epoch,
index])`` in a fixed order (each camera's resize, bottom share, crop
width and, with ``rand_flip``, flip; the sweeps; the points' subsample),
so a sample does not depend on which loader thread made it, and the
port's batches equal the JAX package's bit for bit.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.geometry import CameraAug
from .batch import Batch

# occupancy 16 -> 5 class remap (loading.py:90-94)
OCC_REMAP = {
    255: [0, 1, 2, 6, 7, 8, 15],
    1: [3, 4, 5, 9, 10],
    2: [11],
    3: [12, 13, 14],
    4: [16],
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def quaternion_matrix(q) -> np.ndarray:
    """w-x-y-z quaternion -> 3x3 rotation (pyquaternion convention)."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ],
        np.float32,
    )


def load_infos(ann_file: str, load_interval: float = 1.0):
    """Timestamp-sorted info list; every ``load_interval``-th info, or the
    first ``load_interval`` share of them when it is below 1."""
    with open(ann_file, "rb") as f:
        data = pickle.load(f)
    infos = sorted(data["infos"], key=lambda e: e["timestamp"])
    if load_interval >= 1:
        return infos[:: int(load_interval)]
    n = int(len(infos) * load_interval)
    return infos[:n]


def camera_matrices(info) -> tuple[np.ndarray, None]:
    """Per-camera lidar2image ``(N, 4, 4)``, in the infos' dict order."""
    l2is = []
    for cam in info["cams"].values():
        r = np.asarray(cam["sensor2lidar_rotation"], np.float64)
        t = np.asarray(cam["sensor2lidar_translation"], np.float64)
        l2c_r = np.linalg.inv(r)
        l2c_t = t @ l2c_r.T
        rt = np.eye(4, dtype=np.float32)
        rt[:3, :3] = l2c_r.T
        rt[3, :3] = -l2c_t
        intr = np.eye(4, dtype=np.float32)
        intr[:3, :3] = cam["camera_intrinsics"]
        l2is.append(intr @ rt.T)
    return np.stack(l2is), None


class ImageAug:
    """ImageAug3D's resize / crop / flip sampler."""

    def __init__(self, final_dim=(256, 512), resize_lim=(0.44, 0.61),
                 bot_pct_lim=(0.0, 0.0), rand_flip=True, is_train=True):
        self.final_dim = tuple(final_dim)
        self.resize_lim = resize_lim
        self.bot_pct_lim = bot_pct_lim
        self.rand_flip = rand_flip
        self.is_train = is_train

    def sample(self, ori_wh, rng: np.random.Generator):
        """``(resize, (newW, newH), crop box, flip)``; in training the
        flip is drawn only when ``rand_flip`` is set."""
        W, H = ori_wh
        fH, fW = self.final_dim
        if self.is_train:
            resize = rng.uniform(*self.resize_lim)
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - rng.uniform(*self.bot_pct_lim)) * newH) - fH
            crop_w = int(rng.uniform(0, max(0, newW - fW)))
            flip = bool(self.rand_flip and rng.choice([0, 1]))
        else:
            resize = float(np.mean(self.resize_lim))
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - np.mean(self.bot_pct_lim)) * newH) - fH
            crop_w = int(max(0, newW - fW) / 2)
            flip = False
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        return resize, (newW, newH), crop, flip


def _load_image(path, resize_dims, crop, flip):
    """Decode, bicubic resize, crop, flip and normalise one camera image:
    ``(H, W, 3)`` float32."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = img.resize(resize_dims, Image.BICUBIC)
    img = img.crop(crop)
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def load_occupancy(path: str) -> np.ndarray:
    """Sparse occupancy rows ``(x, y, z, label16)`` -> the remapped dense
    ``(200, 200, 16)`` int32 grid."""
    occ = np.load(path)
    labels = occ[..., 3].copy()
    for new, olds in OCC_REMAP.items():
        for old in olds:
            labels[occ[..., 3] == old] = new
    dense = np.zeros((200, 200, 16), np.int32)
    dense[
        occ[:, 0].astype(int), occ[:, 1].astype(int), occ[:, 2].astype(int)
    ] = labels.astype(np.int32)
    return dense


class NuScenesDataset:
    """Sample producer: numpy samples, host-tensor :class:`Batch` es."""

    def __init__(self, cfg: dict, split: str = "train", seed: int = 0):
        self.cfg = cfg
        self.root = cfg["data_root"]
        ann = cfg["ann_train"] if split == "train" else cfg["ann_val"]
        self.infos = load_infos(os.path.join(self.root, ann))
        self.is_train = split == "train"
        self.aug = ImageAug(
            final_dim=cfg["image_size"],
            resize_lim=cfg["resize_lim"],
            rand_flip=cfg["rand_flip"] and self.is_train,
            is_train=self.is_train,
        )
        self.base_seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Advance the per-epoch augmentation stream."""
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.infos)

    def sample(self, index: int) -> dict:
        """One sample as a dict of numpy arrays (no batch dim), drawn from
        its own ``(seed, epoch, index)`` Generator: loader threads never
        share one, and a fixed seed reproduces exactly."""
        rng = np.random.default_rng([self.base_seed, self.epoch, index])
        info = self.infos[index]
        cfg = self.cfg
        H, W = cfg["image_size"]
        N = cfg["num_cams"]

        lidar2img, _ = camera_matrices(info)

        imgs = np.zeros((N, H, W, 3), np.float32)
        resize = np.zeros((N,), np.float32)
        crop = np.zeros((N, 2), np.float32)
        flip = np.zeros((N,), bool)
        for i, cam in enumerate(info["cams"].values()):
            path = os.path.join(self.root, cam["data_path"])
            from PIL import Image

            with Image.open(path) as im:
                ori_wh = im.size
            r, dims, cr, fl = self.aug.sample(ori_wh, rng)
            imgs[i] = _load_image(path, dims, cr, fl)
            resize[i], crop[i], flip[i] = r, cr[:2], fl

        out = dict(
            img=imgs,
            lidar2img=lidar2img.astype(np.float32),
            cam_resize=resize,
            cam_crop=crop,
            cam_flip=flip,
        )

        rf = info.get("range_filename")
        if rf:
            # the infos hold the whole name, .npz included
            npz = np.load(os.path.join(self.root, rf))
            out["range_image"] = npz["range_image"][..., None].astype(
                np.float32
            )
            out["range_points"] = npz["range_points"].astype(np.float32)

        if cfg.get("load_points"):
            pts = np.fromfile(
                os.path.join(self.root, info["lidar_path"]), np.float32
            ).reshape(-1, cfg["point_dim"])
            n_sweeps = int(cfg.get("sweeps_num", 0))
            if n_sweeps > 0:
                pts = self._aggregate_sweeps(info, pts, n_sweeps, rng)
            P = cfg["point_budget"]
            buf = np.zeros((P, cfg["point_dim"]), np.float32)
            n = min(len(pts), P)
            if len(pts) > P:
                # The reference keeps every point (ragged lists); a static
                # budget must not favour file order, which would drop
                # whole later sweeps.  Train: a uniform random subsample.
                # Val: a deterministic stride, uniform over the sweeps.
                if self.is_train:
                    keep = rng.choice(len(pts), P, replace=False)
                else:
                    keep = np.linspace(0, len(pts) - 1, P).astype(np.int64)
                pts = pts[keep]
            buf[:n] = pts[:n]
            out["points"] = buf
            out["points_valid"] = np.arange(P) < n

        if cfg.get("load_occ") and "occ_filename" in info:
            out["occupancy"] = load_occupancy(
                os.path.join(self.root, info["occ_filename"])
            )

        if cfg.get("load_elev") and "elev_filename" in info:
            npz = np.load(os.path.join(self.root, info["elev_filename"]))
            out["elevation"] = npz["elevation"].astype(np.float32)
            out["elevation_mask"] = npz["mask"].astype(np.float32)

        return out

    def _aggregate_sweeps(self, info, key_pts, sweeps_num, rng):
        """Multi-sweep aggregation: each sweep moved into the keyframe's
        LiDAR frame, its time lag in channel 4 (keyframe points: 0)."""
        key_pts = key_pts.copy()
        if key_pts.shape[1] > 4:
            key_pts[:, 4] = 0.0
        out = [key_pts]
        sweeps = info.get("sweeps", [])
        ts = info["timestamp"] / 1e6
        if len(sweeps) <= sweeps_num:
            choices = np.arange(len(sweeps))
        elif not self.is_train:
            choices = np.arange(sweeps_num)
        else:
            choices = rng.choice(len(sweeps), sweeps_num, replace=False)
        for idx in choices:
            sw = sweeps[idx]
            p = np.fromfile(
                os.path.join(self.root, sw["data_path"]), np.float32
            ).reshape(-1, 5)
            p[:, :3] = p[:, :3] @ np.asarray(
                sw["sensor2lidar_rotation"], np.float32
            ).T + np.asarray(sw["sensor2lidar_translation"], np.float32)
            p[:, 4] = ts - sw["timestamp"] / 1e6
            if key_pts.shape[1] > 5:
                p = np.pad(p, ((0, 0), (0, key_pts.shape[1] - 5)))
            out.append(p.astype(np.float32))
        return np.concatenate(out, axis=0)

    def batch(self, indices) -> Batch:
        """Stack samples into a :class:`Batch` of host (CPU) tensors."""
        samples = [self.sample(i) for i in indices]

        def stack(key, default=None):
            if key not in samples[0]:
                return default
            return torch.from_numpy(np.stack([s[key] for s in samples]))

        return Batch(
            img=stack("img"),
            range_image=stack(
                "range_image",
                torch.zeros((len(samples), 32, 1024, 1), dtype=torch.float32),
            ),
            range_points=stack(
                "range_points",
                torch.zeros((len(samples), 32, 1024, 3), dtype=torch.float32),
            ),
            lidar2img=stack("lidar2img"),
            cam_aug=CameraAug(
                resize=stack("cam_resize"),
                crop=stack("cam_crop"),
                flip=stack("cam_flip"),
            ),
            points=stack("points"),
            points_valid=stack("points_valid"),
            occupancy=stack("occupancy"),
            elevation=stack("elevation"),
            elevation_mask=stack("elevation_mask"),
        )


def process_local_indices(
    order: np.ndarray,
    global_batch: int,
    step: int,
    process_index: int = 0,
    process_count: int = 1,
) -> np.ndarray:
    """This process's sample indices for global step ``step``.

    The DistributedSampler law: the epoch ``order`` is the same on every
    process (same shuffle seed); step ``i``'s global batch is
    ``order[i*B : (i+1)*B]`` and process ``r`` takes the contiguous slice
    ``[r*B_local : (r+1)*B_local]`` of it, so the processes' slices in
    rank order make up the single-process global batch.
    """
    if global_batch % process_count:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{process_count} processes"
        )
    local = global_batch // process_count
    start = step * global_batch + process_index * local
    return order[start : start + local]


def epoch_batches(
    dataset: NuScenesDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    prefetch: int = 4,
    workers: int = None,
    process_index: int = 0,
    process_count: int = 1,
):
    """Generator of one epoch's Batches, made ahead by a thread pool.

    A thread pool decodes the JPEGs and reads the npz files in parallel
    (Pillow and numpy's IO release the GIL) while the device computes;
    batches come out in order, ``prefetch`` of them in flight.  The
    order is ``np.random.default_rng(seed).shuffle`` of the indices, and
    ``seed`` also becomes the dataset's epoch (``set_epoch(seed)``).

    ``batch_size`` is the global batch; with ``process_count > 1`` each
    process runs this generator with the same ``seed`` and yields its own
    ``batch_size / process_count`` slice of each global batch
    (:func:`process_local_indices`).
    """
    from concurrent.futures import ThreadPoolExecutor

    if workers is None:
        workers = int(dataset.cfg.get("workers", 4))
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(seed)
    n_batches = len(order) // batch_size
    if n_batches == 0:
        return

    def make(i):
        idx = process_local_indices(
            order, batch_size, i, process_index, process_count
        )
        return dataset.batch(idx)

    with ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
        pending = [
            pool.submit(make, i) for i in range(min(prefetch, n_batches))
        ]
        nxt = len(pending)
        for _ in range(n_batches):
            fut = pending.pop(0)
            if nxt < n_batches:
                pending.append(pool.submit(make, nxt))
                nxt += 1
            yield fut.result()
