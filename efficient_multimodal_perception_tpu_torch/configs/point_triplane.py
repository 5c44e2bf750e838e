"""point_triplane: the point family's pretraining, and its shared model
block (``_point_model_common``): the point -> triplane projector over a
128 x 128 x 80 grid, a ConvNeXt-tiny camera encoder (stride-2 stem,
stage 3 out), a ConvNeXt-tiny triplane encoder shared by the three
planes (128-channel input, stride-1 stem, all four stages out) and the
GeneralizedLSSFPN neck (96 channels).  ``PointTriplane`` adds the MiT
camera reconstruction decoder and the InterpNet surface decoder
(contrastive off)."""

from ._base import data_nuscenes, runtime, schedule_cosine


def _point_model_common():
    return dict(
        point_triplane_projector=dict(
            type="PointTriplaneProjector",
            grid_size=(128, 128, 80),
            base_channels=128,
            split=(25, 25, 20),
            in_channels=5,
            out_channels=128,
        ),
        camera_encoder=dict(
            type="MaskConvNeXt",
            arch="tiny",
            drop_path_rate=0.2,
            out_indices=3,
            norm_out=True,
            frozen_stages=1,
            stem_patch_size=(2, 2),
        ),
        triplane_encoder=dict(
            type="MaskConvNeXt",
            arch="tiny",
            drop_path_rate=0.2,
            out_indices=3,
            norm_out=True,
            frozen_stages=1,
            stem_patch_size=(1, 1),
            out_all_scale=True,
            in_channels=128,
        ),
        fpn=dict(
            type="GeneralizedLSSFPN",
            in_channels=(96, 192, 384, 768),
            out_channels=96,
            start_level=0,
            num_outs=3,
            align_corners=False,
        ),
    )


def get_config():
    return dict(
        name="point_triplane",
        model=dict(
            type="PointTriplane",
            **_point_model_common(),
            camera_decoder=dict(
                type="MixVisionTransformerHead",
                patch_size=(7, 7),
                stride=(4, 4),
                in_chans=96,
                embed_dim=96,
                norm_pix_loss=False,
                actual_patch_size=(4, 4),
                img_in_chans=3,
            ),
            surface_decoder=dict(
                type="InterpNet",
                latent_size=96,
                out_channels=1,
                radius=1.0,
                n_non_manifold_pts=2048,
                non_manifold_dist=0.1,
            ),
            contrastive=False,
            voxel_size=(0.4, 0.4, 0.1),
            pc_range=(-25, -25, -5, 25, 25, 3),
        ),
        model_init=dict(ckpt_path=None, freeze=()),
        data=data_nuscenes(load_points=True),
        **schedule_cosine(),
        **runtime(),
    )
