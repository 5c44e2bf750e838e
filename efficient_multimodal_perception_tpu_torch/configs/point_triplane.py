"""The point family's shared model block (copy of the JAX package's
``configs/point_triplane.py`` ``_point_model_common``): the point ->
triplane projector over a 128 x 128 x 80 grid, a ConvNeXt-tiny camera
encoder (stride-2 stem, stage 3 out), a ConvNeXt-tiny triplane encoder
shared by the three planes (128-channel input, stride-1 stem, all four
stages out) and the GeneralizedLSSFPN neck (96 channels).  The
pretraining config itself (``PointTriplane``) is not ported."""


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
