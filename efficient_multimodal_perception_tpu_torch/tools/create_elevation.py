"""Write ``<save-path>/<lidar file>.npz`` BEV maximum-height maps
(``elevation`` (100, 100), ``mask``) for every nuScenes sample
(``data/prep.make_elevation``); needs the ``nuscenes`` devkit and the
dataset on disk::

    python -m efficient_multimodal_perception_tpu_torch.tools.create_elevation \\
        --dataroot data/nuscenes --save-path data/nuscenes/elevation
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data.nuscenes_converter import lidar_clouds
from ..data.prep import make_elevation


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataroot", required=True)
    p.add_argument("--save-path", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    args = p.parse_args(argv)

    from nuscenes.nuscenes import NuScenes

    os.makedirs(args.save_path, exist_ok=True)
    nusc = NuScenes(version=args.version, dataroot=args.dataroot, verbose=True)
    count = 0
    for filename, points in lidar_clouds(nusc):
        name = os.path.split(filename)[-1].split(".")[0]
        np.savez(os.path.join(args.save_path, name), **make_elevation(points))
        count += 1
        if count % 100 == 0:
            print(count, flush=True)
    print(f"wrote {count} elevation maps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
