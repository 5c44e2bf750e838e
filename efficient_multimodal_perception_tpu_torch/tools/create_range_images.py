"""Write ``samples/RANGE_FULL/<lidar file>.npz`` range images (``range_image``
(32, 1024), ``range_points``) for every nuScenes sample, beside its LiDAR
file (``data/prep.make_range_image``); needs the ``nuscenes`` devkit and
the dataset on disk::

    python -m efficient_multimodal_perception_tpu_torch.tools.create_range_images \\
        --dataroot data/nuscenes --version v1.0-trainval
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data.nuscenes_converter import lidar_clouds
from ..data.prep import make_range_image


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    args = p.parse_args(argv)

    from nuscenes.nuscenes import NuScenes

    nusc = NuScenes(version=args.version, dataroot=args.dataroot, verbose=True)
    count = 0
    for filename, points in lidar_clouds(nusc):
        dst = filename.replace("LIDAR_TOP", "RANGE_FULL")
        dst = os.path.join(nusc.dataroot, dst.replace(".pcd.bin", ""))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        np.savez(dst, **make_range_image(points))
        count += 1
        if count % 100 == 0:
            print(count, flush=True)
    print(f"wrote {count} range images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
