"""Tiny configs for fast CPU tests: the shipped topology and spatial
shapes (the neck needs the (32 + 6*16, 32) strip) with ~100x fewer
channels.  ``tiny_occ``, ``tiny_point_occ`` (the JAX package's
``tiny_point(occ=True)``), ``tiny_range_cam`` (its
``tiny_mae(contrastive=False, surface=False)``), ``tiny_surf_sam`` (its
``tiny_mae(contrastive=True, surface=True, recon=False)``: the surface
decoder and SupCon without reconstruction decoders, as
``triplane_surf_sam``), ``tiny_point`` (its ``tiny_point(occ=False)``:
``PointTriplane`` with the camera, contrastive and surface losses, on
64 x 128 images) and ``tiny_elev`` (the full (100, 100, 80) elevation
volume under the one-block head)."""

from ._base import data_nuscenes, runtime, schedule_cosine

TINY_ARCH = {"depths": (1, 1, 1, 1), "channels": (8, 16, 32, 64)}


def tiny_encoder():
    return dict(
        type="JointEncoder",
        lidar_encoder=dict(
            arch=TINY_ARCH,
            out_indices=3,
            norm_out=True,
            in_channels=17,  # 1 + camera stage-1 channels
            stem_patch_size=(1, 4),
            downsample_height=False,
            drop_path_rate=0.1,
        ),
        camera_encoder=dict(
            arch=TINY_ARCH,
            out_indices=1,
            norm_out=True,
            stem_patch_size=(2, 2),
            drop_path_rate=0.1,
        ),
        embed_dims=16,
        lidar_mask_ratio=0.0,
        camera_mask_ratio=0.0,
    )


def tiny_neck():
    return dict(
        type="MixVisionTransformer",
        img_size=(128, 32),
        patch_size=1,
        in_chans=64,
        embed_dim=64,
    )


def tiny_occ():
    return dict(
        type="TriplaneOcc",
        encoder=tiny_encoder(),
        neck=tiny_neck(),
        decoder=dict(type="Mlp", input_dim=32, num_classes=5),
        voxel_size=(0.5, 0.5, 0.5),
        occ_range=(-25, -25, -5, 25, 25, 3),
        triplane_range=(-25, -25, -5, 25, 25, 3),
        triplane_voxel_size=(0.4, 0.4, 0.1),
        embed_dim=64,
    )


def tiny_mae(contrastive=True, surface=True, recon=True):
    """The JAX package's ``tiny_mae``."""
    m = dict(
        type="TriplaneMAE",
        encoder=tiny_encoder(),
        neck=tiny_neck(),
        contrastive=contrastive,
        voxel_size=(0.4, 0.4, 0.1),
        pc_range=(-25, -25, -5, 25, 25, 3),
        max_sam_clusters=64,
        embed_dim=64,
    )
    if recon:
        m["camera_decoder"] = dict(
            type="MixVisionTransformerHead",
            patch_size=(7, 7),
            stride=(4, 4),
            in_chans=32,
            embed_dim=32,
            actual_patch_size=(4, 4),
            img_in_chans=3,
        )
        m["lidar_decoder"] = dict(
            type="MixVisionTransformerHead",
            patch_size=(1, 7),
            stride=(1, 4),
            in_chans=32,
            embed_dim=32,
            actual_patch_size=(1, 4),
            img_in_chans=1,
        )
    if surface:
        m["surface_decoder"] = dict(
            type="InterpNet",
            latent_size=32,
            out_channels=1,
            radius=1.0,
            n_non_manifold_pts=256,
            non_manifold_dist=0.1,
        )
    return m


def tiny_point(occ=False):
    """The JAX package's ``tiny_point``: a 32 x 32 x 16 grid, 16-channel
    projector, tiny encoders and a 24-channel FPN, under the occupancy
    head (``occ``) or the pretraining heads."""
    common = dict(
        point_triplane_projector=dict(
            type="PointTriplaneProjector",
            grid_size=(32, 32, 16),
            base_channels=16,
            split=(8, 8, 4),
            in_channels=5,
            out_channels=16,
        ),
        camera_encoder=dict(
            type="MaskConvNeXt",
            arch=TINY_ARCH,
            out_indices=3,
            norm_out=True,
            stem_patch_size=(2, 2),
        ),
        triplane_encoder=dict(
            type="MaskConvNeXt",
            arch=TINY_ARCH,
            out_indices=3,
            norm_out=True,
            stem_patch_size=(1, 1),
            out_all_scale=True,
            in_channels=16,
        ),
        fpn=dict(
            type="GeneralizedLSSFPN",
            in_channels=(8, 16, 32, 64),
            out_channels=24,
        ),
    )
    if occ:
        return dict(
            type="PointTriplaneOcc",
            **common,
            decoder=dict(type="Mlp", input_dim=24, num_classes=5),
            voxel_size=(0.5, 0.5, 0.5),
            occ_range=(-25, -25, -5, 25, 25, 3),
            triplane_range=(-25, -25, -5, 25, 25, 3),
            triplane_voxel_size=(50 / 32, 50 / 32, 8 / 16),
        )
    return dict(
        type="PointTriplane",
        **common,
        camera_decoder=dict(
            type="MixVisionTransformerHead",
            patch_size=(7, 7),
            stride=(4, 4),
            in_chans=24,
            embed_dim=32,
            actual_patch_size=(4, 4),
            img_in_chans=3,
        ),
        surface_decoder=dict(
            type="InterpNet",
            latent_size=24,
            out_channels=1,
            radius=1.0,
            n_non_manifold_pts=256,
            non_manifold_dist=0.1,
        ),
        contrastive=True,
        voxel_size=(50 / 32, 50 / 32, 8 / 16),
        pc_range=(-25, -25, -5, 25, 25, 3),
        max_sam_clusters=64,
    )


def tiny_elev():
    return dict(
        type="TriplaneElev",
        encoder=tiny_encoder(),
        neck=tiny_neck(),
        decoder=dict(type="ResnetBasicBlock", input_dim=32, height_dim=80),
        volume=(100, 100, 80),
        voxel_size=(0.4, 0.4, 0.1),
        pc_range=(-20, -20, -5, 20, 20, 3),
        triplane_range=(-25, -25, -5, 25, 25, 3),
        embed_dim=64,
    )


def tiny_data(point_budget: int = 4096, image_size=(256, 512), **flags):
    """``data_nuscenes(**flags)`` at a tiny config's point budget and
    image size."""
    data = data_nuscenes(**flags)
    data.update(point_budget=point_budget, image_size=image_size)
    return data


def get_config():
    return dict(name="tiny_occ", model=tiny_occ(),
                model_init=dict(ckpt_path=None, freeze=("encoder", "neck")),
                data=tiny_data(load_occ=True),
                **schedule_cosine(warmup_ratio=0.5), **runtime())


def get_point_occ_config():
    return dict(name="tiny_point_occ", model=tiny_point(occ=True),
                model_init=dict(ckpt_path=None, freeze=()),
                data=tiny_data(load_points=True, load_occ=True),
                **schedule_cosine(warmup_ratio=0.5), **runtime())


def get_range_cam_config():
    return dict(name="tiny_range_cam",
                model=tiny_mae(contrastive=False, surface=False),
                model_init=dict(ckpt_path=None, freeze=()),
                data=tiny_data(),
                **schedule_cosine(), **runtime())


def get_elev_config():
    return dict(name="tiny_elev", model=tiny_elev(),
                model_init=dict(ckpt_path=None, freeze=("encoder", "neck")),
                data=tiny_data(load_elev=True),
                **schedule_cosine(warmup_iters=1000,
                                  min_lr_ratio=1e-7 / 2.5e-4),
                **runtime())


def get_surf_sam_config():
    return dict(name="tiny_surf_sam", model=tiny_mae(recon=False),
                model_init=dict(ckpt_path=None, freeze=()),
                data=tiny_data(load_points=True),
                **schedule_cosine(), **runtime())


def get_point_config():
    return dict(name="tiny_point", model=tiny_point(),
                model_init=dict(ckpt_path=None, freeze=()),
                data=tiny_data(load_points=True, point_budget=2048,
                               image_size=(64, 128)),
                **schedule_cosine(), **runtime())
