"""point_triplane_occ: point-family 3-D semantic occupancy (the
projector, ConvNeXt-tiny camera and triplane encoders, GeneralizedLSSFPN,
Mlp occupancy head, 5 classes) over raw LiDAR points and 6 cameras.

It trains the whole model from scratch, as the JAX package's config does
(``model_init.freeze=()``; each encoder's stem and stage 0 are frozen by
its ``frozen_stages=1``)."""

from ._base import data_nuscenes, runtime, schedule_cosine
from .point_triplane import _point_model_common
from .triplane_occ import CLASS_NAMES


def get_config():
    return dict(
        name="point_triplane_occ",
        model=dict(
            type="PointTriplaneOcc",
            **_point_model_common(),
            decoder=dict(type="Mlp", input_dim=96, num_classes=5),
            voxel_size=(0.5, 0.5, 0.5),
            occ_range=(-25, -25, -5, 25, 25, 3),
            triplane_range=(-25, -25, -5, 25, 25, 3),
            triplane_voxel_size=(0.4, 0.4, 0.1),
            class_names=CLASS_NAMES,
        ),
        model_init=dict(ckpt_path=None, freeze=()),
        data=data_nuscenes(load_points=True, load_occ=True),
        **schedule_cosine(warmup_ratio=0.5),
        **runtime(),
    )
