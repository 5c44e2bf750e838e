"""triplane_occ: 3-D semantic occupancy fine-tune (ConvNeXt-tiny
encoders, MiT neck with embed 1024, Mlp occupancy head, 5 classes; the
encoder and neck come frozen from the pretrain checkpoint)."""

from ._base import (
    convnext_camera,
    convnext_lidar,
    mit_neck,
    runtime,
    schedule_cosine,
)

CLASS_NAMES = ("vehicle", "drivable_surface", "other_surface", "vegetation")


def get_config():
    return dict(
        name="triplane_occ",
        model=dict(
            type="TriplaneOcc",
            encoder=dict(
                type="JointEncoder",
                lidar_encoder=convnext_lidar("tiny"),
                camera_encoder=convnext_camera("tiny"),
            ),
            neck=mit_neck(),
            decoder=dict(type="Mlp", input_dim=32, num_classes=5),
            volume=(100, 100, 80),
            voxel_size=(0.5, 0.5, 0.5),
            occ_range=(-25, -25, -5, 25, 25, 3),
            triplane_range=(-25, -25, -5, 25, 25, 3),
            triplane_voxel_size=(0.4, 0.4, 0.1),
            class_names=CLASS_NAMES,
            freeze_encoder=True,
        ),
        model_init=dict(
            ckpt_path=None,  # the pretrain checkpoint (train.cli --ckpt-path)
            freeze=("encoder", "neck"),  # freeze_encoder=True
        ),
        data=dict(num_cams=6, image_size=(256, 512), point_budget=36864,
                  samples_per_device=1, load_occ=True),
        **schedule_cosine(warmup_ratio=0.5),
        **runtime(),
    )
