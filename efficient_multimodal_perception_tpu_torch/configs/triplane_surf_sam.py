"""triplane_surf_sam: SAM-cluster contrastive + implicit-surface
pretraining (ConvNeXt-small encoders, MiT neck with embed 1024, the
InterpNet surface decoder and the SupCon loss over the SAM label
channels; no image or range reconstruction decoders, masking off)."""

from ._base import (
    data_nuscenes,
    convnext_camera,
    convnext_lidar,
    mit_neck,
    runtime,
    schedule_cosine,
)


def get_config():
    return dict(
        name="triplane_surf_sam",
        model=dict(
            type="TriplaneMAE",
            encoder=dict(
                type="JointEncoder",
                lidar_encoder=convnext_lidar("small"),
                camera_encoder=convnext_camera("small"),
                lidar_mask_ratio=0.0,
                camera_mask_ratio=0.0,
            ),
            neck=mit_neck(),
            surface_decoder=dict(
                type="InterpNet",
                latent_size=32,
                out_channels=1,
                radius=1.0,
                n_non_manifold_pts=2048,
                non_manifold_dist=0.1,
            ),
            contrastive=True,
            voxel_size=(0.4, 0.4, 0.1),
            pc_range=(-25, -25, -5, 25, 25, 3),
        ),
        model_init=dict(ckpt_path=None, freeze=()),
        data=data_nuscenes(load_points=True),
        **schedule_cosine(),
        **runtime(),
    )
