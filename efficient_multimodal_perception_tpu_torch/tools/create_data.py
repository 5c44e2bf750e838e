"""Create the nuScenes infos pkls (``nuscenes_infos_{train,val}.pkl``)
with the port's converter (``data/nuscenes_converter.py``); needs the
``nuscenes`` devkit and the dataset on disk::

    python -m efficient_multimodal_perception_tpu_torch.tools.create_data \\
        nuscenes --root-path data/nuscenes --version v1.0-trainval \\
        --max-sweeps 10
"""

from __future__ import annotations

import argparse
import sys

from ..data.nuscenes_converter import create_nuscenes_infos


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dataset", choices=["nuscenes"])
    p.add_argument("--root-path", required=True)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--max-sweeps", type=int, default=10)
    args = p.parse_args(argv)
    create_nuscenes_infos(args.root_path, args.out_dir, args.version,
                          args.max_sweeps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
