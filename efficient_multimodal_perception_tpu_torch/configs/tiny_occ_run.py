"""tiny_occ_run: the tiny ``TriplaneOcc`` topology behind the real
schedule, runtime and nuScenes data blocks (copy of the JAX package's
``configs/tiny_occ_run.py``): a debug profile that runs the whole CLI
path (config, loader, trainer, checkpoint, evaluation) in seconds on the
CPU."""

from ._base import data_nuscenes, runtime, schedule_cosine
from .tiny import tiny_occ


def get_config():
    cfg = dict(
        name="tiny_occ_run",
        model=tiny_occ(),
        model_init=dict(ckpt_path=None, freeze=("encoder", "neck")),
        data=data_nuscenes(load_occ=True),
        **schedule_cosine(warmup_ratio=0.5),
        **runtime(),
    )
    # one sample per device, tiny point budget
    cfg["data"]["samples_per_device"] = 1
    cfg["data"]["point_budget"] = 512
    return cfg
