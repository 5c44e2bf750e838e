"""Write a nuScenes-shaped world of files that ``data/nuscenes.py`` reads:
the converter's infos schema, the cameras' JPEGs, the LiDAR bins and the
range, elevation and occupancy files derived from them.

    python -m efficient_multimodal_perception_tpu_torch.tools.fixture_world \
        OUT_DIR [--train 8] [--val 2] [--seed 0]

Each sample has six 1600 x 900 JPEGs on a ring of cameras with the
nuScenes cameras' yaws and a focal length of 1266 px (smooth content
with mild noise, a few hundred KB a file, as real frames are), a
keyframe of 34000 points x 11 drawn on 32 beams as
``data/synthetic.py`` draws them (x, y, z, intensity, ring, six SAM
cluster ids), the range image and the elevation map that ``data/prep``
makes of those points, and 30000 sparse occupancy rows (x, y, z,
label16) over the (200, 200, 16) grid: every voxel a point falls in,
then random ones.  Everything comes from ``--seed``; nothing is fetched.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

from ..data.prep import make_elevation, make_range_image

CAMS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK",
        "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
CAM_YAW_DEG = (0.0, 55.0, -55.0, 180.0, -110.0, 110.0)  # clockwise from +y
INTRINSICS = ((1266.0, 0.0, 816.0), (0.0, 1266.0, 491.0), (0.0, 0.0, 1.0))
IMAGE_WH = (1600, 900)
N_POINTS = 34000
OCC_ROWS = 30000
OCC_GRID = (200, 200, 16)
OCC_RANGE = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)  # 0.4 m voxels
BEAMS_DEG = (-29.5, 9.5)


def camera_record(yaw_deg: float, data_path: str) -> dict:
    """One camera of an info: LiDAR axes x right, y forward, z up; the
    camera looks along yaw (clockwise from +y), x right, y down."""
    a = np.deg2rad(yaw_deg)
    fwd = np.array([np.sin(a), np.cos(a), 0.0])
    right = np.array([np.cos(a), -np.sin(a), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    rot = np.stack([right, down, fwd], axis=1)  # camera -> LiDAR
    return dict(
        data_path=data_path,
        type=data_path.split("/")[1],
        sensor2lidar_rotation=rot,
        sensor2lidar_translation=0.7 * fwd + np.array([0.0, 0.0, -0.3]),
        camera_intrinsics=np.array(INTRINSICS),
        sensor2ego_rotation=[1.0, 0.0, 0.0, 0.0],
        sensor2ego_translation=[0.0, 0.0, 0.0],
    )


def lidar_points(rng: np.random.Generator) -> np.ndarray:
    """``(N_POINTS, 11)`` float32: a 32-beam cloud with intensity, ring and
    six SAM cluster ids (0-39)."""
    n = N_POINTS
    beams = np.deg2rad(np.linspace(*BEAMS_DEG, 32))
    ring = rng.integers(0, 32, n)
    pitch = beams[ring] + rng.normal(0, 0.002, n)
    yaw = rng.uniform(-np.pi, np.pi, n)
    r = np.abs(rng.gamma(2.0, 8.0, n)) + 2.5
    pts = np.zeros((n, 11), np.float32)
    pts[:, 0] = r * np.cos(pitch) * np.sin(yaw)
    pts[:, 1] = r * np.cos(pitch) * np.cos(yaw)
    pts[:, 2] = r * np.sin(pitch)
    pts[:, 3] = rng.uniform(0, 255, n)
    pts[:, 4] = ring
    pts[:, 5:] = rng.integers(0, 40, (n, 6))
    return pts


def occupancy_rows(rng: np.random.Generator, pts: np.ndarray) -> np.ndarray:
    """``(OCC_ROWS, 4)`` int64 sparse rows: the voxels the points fall in,
    then random free-standing ones, each with a label in 0-16."""
    lo, hi = np.array(OCC_RANGE[:3]), np.array(OCC_RANGE[3:])
    grid = np.array(OCC_GRID)
    v = np.floor((pts[:, :3] - lo) / (hi - lo) * grid).astype(np.int64)
    v = v[((v >= 0) & (v < grid)).all(1)]
    flat = np.unique(np.ravel_multi_index(v.T, OCC_GRID))[:OCC_ROWS]
    rest = np.setdiff1d(np.arange(int(np.prod(grid))), flat)
    flat = np.concatenate([flat, rng.choice(rest, OCC_ROWS - len(flat),
                                            replace=False)])
    xyz = np.stack(np.unravel_index(flat, OCC_GRID), 1)
    return np.concatenate([xyz, rng.integers(0, 17, (OCC_ROWS, 1))],
                          1).astype(np.int64)


def camera_image(rng: np.random.Generator):
    """A smooth ``IMAGE_WH`` frame with mild noise (a Pillow image): a
    sky-to-ground gradient under a bicubic-upsampled coarse colour field."""
    from PIL import Image

    W, H = IMAGE_WH
    coarse = rng.uniform(30, 225, (9, 16, 3)).astype(np.uint8)
    base = np.asarray(Image.fromarray(coarse).resize((W, H), Image.BICUBIC),
                      np.float32)
    ramp = np.linspace(40, -40, H, dtype=np.float32)[:, None, None]
    img = base + ramp + rng.normal(0, 4, (H, W, 3)).astype(np.float32)
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


def write_sample(root: str, s: int, seed: int) -> dict:
    """Write sample ``s``'s files, drawn from ``default_rng([seed, s])``;
    returns its info."""
    rng = np.random.default_rng([seed, s])
    base = f"n{s:04d}"
    lidar = f"samples/LIDAR_TOP/{base}.pcd.bin"
    pts = lidar_points(rng)
    pts.tofile(os.path.join(root, lidar))
    rng_name = f"samples/RANGE_FULL/{base}.npz"
    np.savez(os.path.join(root, rng_name), **make_range_image(pts[:, :3]))
    elev_name = os.path.join("elevation", base) + ".npz"
    np.savez(os.path.join(root, elev_name), **make_elevation(pts[:, :3]))
    occ_name = os.path.join("occupancy", f"{base}.pcd.bin.npy")
    np.save(os.path.join(root, occ_name), occupancy_rows(rng, pts))
    cams = {}
    for cam, yaw in zip(CAMS, CAM_YAW_DEG):
        path = f"samples/{cam}/{base}.jpg"
        camera_image(rng).save(os.path.join(root, path), quality=90)
        cams[cam] = camera_record(yaw, path)
    return dict(
        lidar_path=lidar, token=f"tok{s:04d}", range_filename=rng_name,
        elev_filename=elev_name, occ_filename=occ_name, sweeps=[],
        cams=cams, lidar2ego_translation=[0.0, 0.0, 1.8],
        lidar2ego_rotation=[1.0, 0.0, 0.0, 0.0],
        ego2global_translation=[0.0, 0.0, 0.0],
        ego2global_rotation=[1.0, 0.0, 0.0, 0.0],
        timestamp=1_000_000 + 500_000 * s)


def write_world(root: str, n_train: int = 8, n_val: int = 2,
                seed: int = 0) -> dict:
    """Write the world under ``root``, a sample a thread (numpy and Pillow
    release the GIL); returns ``{"train": infos, "val": infos, "bytes":
    bytes written}``."""
    from concurrent.futures import ThreadPoolExecutor

    for d in ("samples/LIDAR_TOP", "samples/RANGE_FULL", "occupancy",
              "elevation", *(f"samples/{c}" for c in CAMS)):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    n = n_train + n_val
    with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as pool:
        infos = list(pool.map(lambda s: write_sample(root, s, seed),
                              range(n)))
    out = {"train": infos[:n_train], "val": infos[n_train:]}
    for split in ("train", "val"):
        with open(os.path.join(root, f"nuscenes_infos_{split}.pkl"),
                  "wb") as f:
            pickle.dump(dict(infos=out[split],
                             metadata=dict(version="v1.0-trainval")), f)
    out["bytes"] = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(root) for f in fs)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir")
    p.add_argument("--train", type=int, default=8)
    p.add_argument("--val", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    world = write_world(args.out_dir, args.train, args.val, args.seed)
    print(f"wrote {args.train} train and {args.val} val samples, "
          f"{world['bytes'] / 1e6:.1f} MB, under {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
