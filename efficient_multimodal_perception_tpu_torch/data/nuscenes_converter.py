"""nuScenes infos converter (offline, one-shot; the port's copy of the
JAX package's ``data/nuscenes_converter.py``, numpy end to end).

Rebuild of ``data_converter/nuscenes_converter.py:125-387``: produces the
``nuscenes_infos_{train,val}.pkl`` the data layer consumes — per-sample
lidar/camera paths, calibration (lidar2ego/ego2global quaternions + per-
camera sensor2lidar transforms + intrinsics), up to ``max_sweeps`` prior
LiDAR sweeps, 3-D boxes with velocity, weather/night flags parsed from
the scene description, and the derived ``range_filename`` /
``elev_filename`` keys.

Requires the ``nuscenes`` devkit and ``pyquaternion``, which the port does
not bundle: they are imported inside the functions, so the rest of the
package never depends on them.
"""

from __future__ import annotations

import os
import pickle
import re

import numpy as np

CAMERA_TYPES = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_FRONT_LEFT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
)

# nuScenes category -> detection name (NuScenesDataset.NameMapping)
NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}


def weather_flags(description: str) -> np.ndarray:
    """4-bit [clear?, night, ?, rain] flags from the scene description
    (``nuscenes_converter.py:167-180``)."""
    w = np.array([0, 0, 0, 0])
    if re.search("(?<!after )[Rr]ain", description):
        w = w | np.array([0, 0, 0, 1])
    if re.search("Night", description):
        w = w | np.array([0, 1, 0, 0])
    return w


def sensor_to_lidar(nusc, sensor_token, l2e_t, l2e_r_mat, e2g_t, e2g_r_mat):
    """Chain sensor->ego->global->ego'->lidar' transforms
    (``obtain_sensor2top``, ``nuscenes_converter.py:329-387``).

    Returns a dict with data_path, sensor2lidar rotation/translation and
    raw calibration quaternions.
    """
    from pyquaternion import Quaternion

    sd = nusc.get("sample_data", sensor_token)
    cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
    pose = nusc.get("ego_pose", sd["ego_pose_token"])

    s2e_r = Quaternion(cs["rotation"]).rotation_matrix
    s2e_t = np.array(cs["translation"])
    seg_r = Quaternion(pose["rotation"]).rotation_matrix
    seg_t = np.array(pose["translation"])

    # sensor -> global
    R = seg_r @ s2e_r
    T = seg_r @ s2e_t + seg_t
    # global -> key-frame lidar
    inv_l = np.linalg.inv(l2e_r_mat)
    inv_g = np.linalg.inv(e2g_r_mat)
    R_l = inv_l @ inv_g @ R
    T_l = inv_l @ inv_g @ (T - e2g_t) - inv_l @ l2e_t

    return dict(
        data_path=sd["filename"],
        type=sd["channel"],
        sample_data_token=sd["token"],
        sensor2ego_translation=cs["translation"],
        sensor2ego_rotation=cs["rotation"],
        ego2global_translation=pose["translation"],
        ego2global_rotation=pose["rotation"],
        timestamp=sd["timestamp"],
        sensor2lidar_rotation=R_l,
        sensor2lidar_translation=T_l,
    )


def create_nuscenes_infos(
    root_path: str,
    out_dir: str | None = None,
    version: str = "v1.0-trainval",
    max_sweeps: int = 10,
):
    """Build and pickle the train/val info lists."""
    from nuscenes.nuscenes import NuScenes
    from nuscenes.utils import splits
    from pyquaternion import Quaternion

    out_dir = out_dir or root_path
    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    if version == "v1.0-mini":
        train_names, val_names = splits.mini_train, splits.mini_val
    elif version == "v1.0-test":
        train_names, val_names = splits.test, []
    else:
        train_names, val_names = splits.train, splits.val
    train_scenes = {
        s["token"] for s in nusc.scene if s["name"] in train_names
    }
    test = version == "v1.0-test"

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd = nusc.get("sample_data", lidar_token)
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        lidar_path, boxes, _ = nusc.get_sample_data(lidar_token)
        if not os.path.isfile(lidar_path):
            continue
        lidar_filename = sd["filename"]
        scene = nusc.get("scene", sample["scene_token"])
        location = nusc.get("log", scene["log_token"])["location"]

        base = os.path.split(lidar_filename)[-1].split(".")[0]
        info = dict(
            lidar_path=lidar_filename,
            token=sample["token"],
            elev_filename=os.path.join("elevation", base) + ".npz",
            range_filename=lidar_filename.replace(
                "LIDAR_TOP", "RANGE_FULL"
            ).replace(".pcd.bin", "")
            + ".npz",
            sweeps=[],
            cams={},
            lidar2ego_translation=cs["translation"],
            lidar2ego_rotation=cs["rotation"],
            ego2global_translation=pose["translation"],
            ego2global_rotation=pose["rotation"],
            timestamp=sample["timestamp"],
            location=location,
            weather=weather_flags(scene["description"]),
        )

        l2e_r_mat = Quaternion(cs["rotation"]).rotation_matrix
        e2g_r_mat = Quaternion(pose["rotation"]).rotation_matrix
        l2e_t = np.array(cs["translation"])
        e2g_t = np.array(pose["translation"])

        for cam in CAMERA_TYPES:
            _, _, intr = nusc.get_sample_data(sample["data"][cam])
            ci = sensor_to_lidar(
                nusc, sample["data"][cam], l2e_t, l2e_r_mat, e2g_t,
                e2g_r_mat,
            )
            ci["camera_intrinsics"] = intr
            info["cams"][cam] = ci

        rec = sd
        while len(info["sweeps"]) < max_sweeps and rec["prev"]:
            info["sweeps"].append(
                sensor_to_lidar(
                    nusc, rec["prev"], l2e_t, l2e_r_mat, e2g_t, e2g_r_mat
                )
            )
            rec = nusc.get("sample_data", rec["prev"])

        if not test:
            annos = [
                nusc.get("sample_annotation", t) for t in sample["anns"]
            ]
            locs = np.array([b.center for b in boxes]).reshape(-1, 3)
            dims = np.array([b.wlh for b in boxes]).reshape(-1, 3)
            rots = np.array(
                [b.orientation.yaw_pitch_roll[0] for b in boxes]
            ).reshape(-1, 1)
            velocity = np.array(
                [nusc.box_velocity(t)[:2] for t in sample["anns"]]
            ).reshape(-1, 2)
            inv = np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
            for i in range(len(boxes)):
                velocity[i] = (np.array([*velocity[i], 0.0]) @ inv)[:2]
            names = np.array(
                [NAME_MAPPING.get(b.name, b.name) for b in boxes]
            )
            info["gt_boxes"] = np.concatenate(
                [locs, dims, -rots - np.pi / 2], axis=1
            )
            info["gt_names"] = names
            info["gt_velocity"] = velocity
            info["num_lidar_pts"] = np.array(
                [a["num_lidar_pts"] for a in annos]
            )
            # attribute names for the native NDS metric's AAE term
            # (the devkit's GT loader reads these from the DB at eval
            # time; carrying them in the infos keeps eval devkit-free)
            info["gt_attrs"] = np.array(
                [
                    nusc.get("attribute", a["attribute_tokens"][0])["name"]
                    if a.get("attribute_tokens") else ""
                    for a in annos
                ]
            )
            info["num_radar_pts"] = np.array(
                [a["num_radar_pts"] for a in annos]
            )
            info["valid_flag"] = np.array(
                [
                    a["num_lidar_pts"] + a["num_radar_pts"] > 0
                    for a in annos
                ],
                bool,
            )

        (train_infos if sample["scene_token"] in train_scenes
         else val_infos).append(info)

    meta = dict(version=version)
    for name, infos in [("train", train_infos), ("val", val_infos)]:
        if name == "val" and test:
            continue
        path = os.path.join(out_dir, f"nuscenes_infos_{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(dict(infos=infos, metadata=meta), f)
        print(f"wrote {len(infos)} infos -> {path}")
    return train_infos, val_infos


def create_nuscenes_occ_infos(
    root_path: str,
    occ_path: str,
    out_dir: str | None = None,
    info_prefix: str = "nuscenes",
    version: str = "v1.0-trainval",
    max_sweeps: int = 10,
):
    """Occ3D-annotated temporal infos.

    Port of ``data_converter/nuscenes_occ_converter.py:31-121``: the
    standard infos plus, per sample, the Occ3D ``annotations.json``
    ground-truth path (``occ_gt_path``) and prev/next temporal links,
    written as ``{prefix}_infos_temporal_{train,val}.pkl``.
    """
    import json

    from nuscenes.nuscenes import NuScenes

    out_dir = out_dir or root_path
    with open(os.path.join(occ_path, "annotations.json")) as f:
        occ_anno = json.load(f)
    scene_infos = occ_anno.get("scene_infos", occ_anno)

    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    token2name = {s["token"]: s["name"] for s in nusc.scene}
    prev_next = {
        s["token"]: (s["prev"], s["next"]) for s in nusc.sample
    }

    train_infos, val_infos = create_nuscenes_infos(
        root_path, out_dir, version, max_sweeps
    )
    for infos in (train_infos, val_infos):
        for info in infos:
            token = info["token"]
            sample = nusc.get("sample", token)
            scene_name = token2name[sample["scene_token"]]
            anno = scene_infos.get(scene_name, {}).get(token, {})
            if "gt_path" in anno:
                info["occ_gt_path"] = anno["gt_path"]
            info["prev"], info["next"] = prev_next[token]
            info["scene_token"] = sample["scene_token"]

    meta = dict(version=version)
    for name, infos in [("train", train_infos), ("val", val_infos)]:
        path = os.path.join(
            out_dir, f"{info_prefix}_infos_temporal_{name}.pkl"
        )
        with open(path, "wb") as f:
            pickle.dump(dict(infos=infos, metadata=meta), f)
        print(f"wrote {len(infos)} temporal infos -> {path}")


def lidar_clouds(nusc):
    """``(LiDAR sample_data filename, points (N, 4))`` of every sample
    whose LiDAR file exists, scene by scene along each scene's ``next``
    chain: the walk of ``tools/create_range_images.py`` and
    ``tools/create_elevation.py``."""
    from nuscenes.utils.data_classes import LidarPointCloud

    for scene in nusc.scene:
        token = scene["first_sample_token"]
        while token:
            sample = nusc.get("sample", token)
            lidar = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
            src = os.path.join(nusc.dataroot, lidar["filename"])
            if os.path.exists(src):
                cloud = LidarPointCloud.from_file(src)
                yield lidar["filename"], cloud.points.T
            token = sample["next"]
