"""Time kernels of two checkouts of the port on one card, alternating,
to tell a change from the spread between runs.

    python -m efficient_multimodal_perception_tpu_torch.tools.ab_trees \
        TREE_A TREE_B [--suite b5|serve|gather] [--rounds 2] [--reps 20] \
        [--out ab.json]

Each round runs A, B, B, A, each in a process of its own that imports
the port from that tree (and builds its kernels there at first use).
Suite ``b5`` (the default) times ``epilogue_fused`` at the six train
shapes of ``triplane_range_cam`` at batch 2 and ``post_epilogue_bwd_wide``
at its two; suite ``serve`` times ``convnext_block_int8_fused`` (B10) at
the 16 ConvNeXt shapes of the two int8 serve paths and
``finite_mlp_fused`` (B9) at the three planes of ``point_triplane_occ``,
all at batch 4 (B9's pools 93% -inf, as the synthetic cloud's are);
suite ``gather`` times ``cam_gather_sum`` (B8's forward) on the
interact's indices of synthetic batches at the serve and train batches
(4 and 2) and ``triplane_sample`` (B7) both ways at batch 2 on the
coordinates the pretraining forward hands it (``b7_path_coords``), and
off the paths on uniform and on ground-like coordinates
(``b7_ground_coords``); B7's backward is timed with a cast to bf16, as
the path ran it while the kernel returned float32.
Every process uses the same seeded inputs: device ms per call summed
over the kernels a call launches (``torch.profiler``), and ms per call
of back-to-back calls between CUDA events.  It prints one line per
process, then each kernel's ms per train step or serve forward (shape
times calls) for every run, and the difference of the means beside each
tree's own range over its runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# (kernel, label, shape, calls per train step or forward of each path):
# B5's shape is (rows, width), B10's (images, H, W, C), B9's (rows, K)
SUITES = {
    "b5": (
        ("epilogue_fused", "camera stage1", (98304, 192), {"train": 3}),
        ("epilogue_fused", "camera stage2", (24576, 384), {"train": 9}),
        ("epilogue_fused", "camera stage3", (6144, 768), {"train": 3}),
        ("epilogue_fused", "lidar stage1", (8192, 192), {"train": 3}),
        ("epilogue_fused", "lidar stage2", (4096, 384), {"train": 9}),
        ("epilogue_fused", "lidar stage3", (2048, 768), {"train": 3}),
        ("post_epilogue_bwd_wide", "camera stage3", (6144, 768),
         {"train": 3}),
        ("post_epilogue_bwd_wide", "lidar stage3", (2048, 768),
         {"train": 3}),
    ),
    "serve": tuple(
        ("convnext_block_int8_fused", f"{enc} stage{i}",
         (n, h >> i * dh, w >> i, 96 << i),
         {p: mult * (3, 3, 9, 3)[i] for p in paths})
        for enc, n, h, w, dh, paths, mult in (
            ("camera", 24, 128, 256, 1, ("i8s", "i8p"), 1),
            ("lidar", 4, 32, 256, 0, ("i8s",), 1),
            ("triplane xy", 4, 128, 128, 1, ("i8p",), 1),
            ("triplane yz|xz", 4, 128, 80, 1, ("i8p",), 2))
        for i in range(4)
    ) + (
        ("finite_mlp_fused", "xy", (65536, 2560), {"p": 1}),
        ("finite_mlp_fused", "yz", (40960, 3200), {"p": 1}),
        ("finite_mlp_fused", "xz", (40960, 3200), {"p": 1}),
    ),
    # B8's shape is (B, N, K, C); B7's (B, S, C, P)
    "gather": (
        ("cam_gather_sum", "path", (4, 6, 8192, 192), {"s": 1, "i8s": 1}),
        ("cam_gather_sum", "path", (2, 6, 8192, 192), {"t": 1, "f": 1}),
        ("triplane_sample", "path", (2, 128, 32, 32768), {"t": 1}),
        ("triplane_sample_bwd", "path", (2, 128, 32, 32768), {"t": 1}),
        ("triplane_sample", "uniform", (2, 128, 32, 32768), {}),
        ("triplane_sample_bwd", "uniform", (2, 128, 32, 32768), {}),
        ("triplane_sample", "ground", (2, 128, 32, 32768), {}),
        ("triplane_sample_bwd", "ground", (2, 128, 32, 32768), {}),
    ),
}

# The range-family shapes of the gather suite and of chip_smoke.py: the
# interact gathers from the stride-4 feature map (64 x 128, C = 192) of
# the 256 x 512 images; the pretraining triplane is 128 x 128 x 32.
B8_FEATURE_HW = (64, 128)


def b8_path_inputs(bsz, dev, batch=None):
    """``(idx, active)`` the interact hands B8 for a synthetic
    ``triplane_occ`` batch of ``bsz`` (seed 0), or for ``batch``: each
    range pixel's row in each camera's feature map ``(bsz, 6, P)`` int32
    and whether a point there is seen ``(bsz, 6, P)`` bool."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.core.geometry import (
        crop_to_range)
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.models.joint_encoder import (
        project_to_features)

    cfg = get_config("triplane_occ")
    if batch is None:
        batch = synthetic_batch(bsz, point_budget=cfg["data"]["point_budget"],
                                seed=0, device=dev)
    m = crop_to_range(batch.range_points,
                      cfg["model"]["triplane_range"])[..., None]
    _, _, active, idx = project_to_features(
        batch.range_image * m, batch.range_points * m, batch.lidar2img,
        batch.cam_aug, cfg["data"]["image_size"], B8_FEATURE_HW)
    return idx, active


def b7_path_coords(bsz, dev, S=128):
    """The coordinates ``TriplaneMAE.forward`` hands B7 for a synthetic
    ``triplane_range_cam`` batch of ``bsz`` (seed 0): the range points
    cropped as ``range_family.encode_triplane`` crops them (points
    outside the range, and empty pixels, at the origin), normalized for
    an ``S`` plane; ``(bsz, P, 3)`` float32."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.core.geometry import (
        crop_to_range)
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.ops.sampling import (
        normalize_triplane_coords)

    cfg = get_config("triplane_range_cam")
    m = cfg["model"]
    batch = synthetic_batch(bsz, point_budget=cfg["data"]["point_budget"],
                            seed=0, device=dev)
    pts = batch.range_points * crop_to_range(batch.range_points,
                                             m["pc_range"])[..., None]
    return normalize_triplane_coords(
        pts.float(), m["pc_range"], m["voxel_size"], S).reshape(
            bsz, -1, 3).contiguous()


def b7_raw_coords(bsz, dev, S=128):
    """The coordinates ``triplane_surf_sam``'s contrastive loss hands B7
    for a synthetic batch of ``bsz`` (seed 0): every raw LiDAR point,
    36864 a sample, in range or not, normalized for an ``S`` plane; the
    padding rows past the cloud's 34000 points sit at the world origin,
    and points beyond the 25 m range lie off the planes or on their edge
    cells.  ``(bsz, 36864, 3)`` float32."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.ops.sampling import (
        normalize_triplane_coords)

    cfg = get_config("triplane_surf_sam")
    m = cfg["model"]
    batch = synthetic_batch(bsz, point_budget=cfg["data"]["point_budget"],
                            seed=0, device=dev)
    return normalize_triplane_coords(
        batch.points[..., :3].float(), m["pc_range"], m["voxel_size"],
        S).contiguous()


def b7_ground_coords(bsz, P, dev, S=128, seed=0):
    """Ground-like B7 coordinates ``(bsz, P, 3)`` float32: x and y uniform
    in [-1, 1], z within 0.45 texel of the centre of row ``S // 3`` of an
    ``S`` plane, as a cloud's ground returns fall in one or two z rows.
    On the yz and xz planes each footprint's cell lies in one of two rows,
    side by side, about P / (2 S) points a cell (128 at 32768 points and
    S = 128): many heavy cells, none longer than a chunk."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    c = torch.rand(bsz, P, 3, generator=gen, device=dev) * 2 - 1
    c[..., 2] = (2 * (S // 3) + 1 + 0.9 * c[..., 2]) / S - 1
    return c.contiguous()


def _call(K, name, label, shape, rn, g, dev):
    """The kernel call of one case, on seeded inputs."""
    import torch

    f32 = torch.float32
    if name == "cam_gather_sum":
        bsz, N, Kf, C = shape
        idx, active = b8_path_inputs(bsz, dev)
        feats, valid = rn(bsz, N, Kf, C), active.to(torch.uint8)
        return lambda: K.cam_gather_sum(feats, idx, valid)
    if name.startswith("triplane_sample"):
        bsz, S, C, P = shape
        coords = (b7_path_coords(bsz, dev, S) if label == "path" else
                  b7_ground_coords(bsz, P, dev, S) if label == "ground" else
                  (torch.rand(bsz, P, 3, generator=g, device=dev) * 2.2
                   - 1.1).contiguous())
        if name == "triplane_sample":
            tri = rn(bsz, 3, S, S, C)
            return lambda: K.triplane_sample(tri, coords)
        gs = rn(bsz, P, C)
        return lambda: K.triplane_sample_bwd(coords, gs, S).to(
            torch.bfloat16)
    if name in ("epilogue_fused", "post_epilogue_bwd_wide"):
        M, C = shape
        prm = (1 + rn(C, scale=0.1, dtype=f32), rn(C, scale=0.1, dtype=f32),
               rn(4 * C, C, scale=C**-0.5), rn(4 * C, scale=0.1, dtype=f32),
               rn(C, 4 * C, scale=(4 * C)**-0.5), rn(C, scale=0.1, dtype=f32),
               torch.rand(C, generator=g, device=dev) + 0.1)
        y, gy = rn(M, C), rn(M, C, scale=0.05)
        if name == "epilogue_fused":
            return lambda: K.epilogue_fused(y, *prm)
        return lambda: K.post_epilogue_bwd_wide(y, gy, *prm)
    if name == "convnext_block_int8_fused":
        C = shape[-1]
        a = (rn(*shape), rn(C, 1, 7, 7, scale=1 / 7, dtype=f32),
             rn(C, scale=0.1, dtype=f32), 1 + rn(C, scale=0.1, dtype=f32),
             rn(C, scale=0.1, dtype=f32), rn(4 * C, C, scale=C**-0.5,
                                             dtype=f32),
             rn(4 * C, scale=0.1, dtype=f32),
             rn(C, 4 * C, scale=(4 * C)**-0.5, dtype=f32),
             rn(C, scale=0.1, dtype=f32),
             torch.rand(C, generator=g, device=dev) * 0.9 + 0.1)
        return lambda: K.convnext_block_int8_fused(*a)
    M, Kd = shape
    x = rn(M, Kd, dtype=f32)
    x[torch.rand(M, Kd, generator=g, device=dev) < 0.93] = float("-inf")
    a = (x.to(torch.bfloat16), rn(128, Kd, scale=Kd**-0.5),
         rn(128, scale=0.1, dtype=f32), rn(128, 128, scale=128**-0.5),
         rn(128, scale=0.1, dtype=f32))
    return lambda: K.finite_mlp_fused(*a)


def _key(name, label, shape):
    return f"{name} {label} {tuple(shape)}"


def _worker(suite: str, reps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from efficient_multimodal_perception_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    out = {"kernels_from": str(Path(K.__file__).resolve().parents[2]),
           "cases": {}}
    for name, label, shape, _ in SUITES[suite]:
        g = torch.Generator(device=dev).manual_seed(sum(shape))

        def rn(*s, scale=1.0, dtype=torch.bfloat16):
            return (torch.randn(*s, generator=g, device=dev)
                    * scale).to(dtype)

        # inputs made outside inference mode, as the models' parameters
        # are (B10 caches the weight codes of tensors that have a version)
        fn = _call(K, name, label, shape, rn, g, dev)
        with torch.no_grad():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            kern = {e.key.split("(")[0][:60]:
                    e.self_device_time_total / 1e3 / reps
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA}
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            torch.cuda.synchronize()
        out["cases"][_key(name, label, shape)] = {
            "device_ms": sum(kern.values()), "event_ms":
            t0.elapsed_time(t1) / reps, "device_ms_by_kernel": kern}
        del fn
        torch.cuda.empty_cache()
    return out


def _run_tree(tree: Path, suite: str, reps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--worker", "--suite", suite, "--reps", str(reps)],
                       cwd=tree, env=env, capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stderr[-4000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    if Path(res["kernels_from"]) != tree.resolve():
        raise RuntimeError(f"{tree}: imported the port from "
                           f"{res['kernels_from']}")
    return res


def _per_path(res: dict, suite: str, kernel: str, path: str,
              key: str) -> float:
    return sum(calls.get(path, 0) * res["cases"][_key(k, label, shape)][key]
               for k, label, shape, calls in SUITES[suite] if k == kernel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--suite", choices=sorted(SUITES), default="b5")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.suite, args.reps)))
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees, A and B")
    a, b = (t.resolve() for t in args.trees)
    runs = []
    for _ in range(args.rounds):
        for tag, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
            res = _run_tree(tree, args.suite, args.reps)
            res["tag"] = tag
            runs.append(res)
            print(tag, json.dumps(res["cases"]), flush=True)
    summary = {}
    pairs = sorted({(k, p) for k, _, _, calls in SUITES[args.suite]
                    for p in calls})
    for kernel, path in pairs:
        for key in ("device_ms", "event_ms"):
            vals = {t: [_per_path(r, args.suite, kernel, path, key)
                        for r in runs if r["tag"] == t] for t in "AB"}
            mean = {t: sum(v) / len(v) for t, v in vals.items()}
            summary[f"{kernel} {key} per {path}"] = dict(
                A=vals["A"], B=vals["B"], mean_A=mean["A"], mean_B=mean["B"],
                B_minus_A=mean["B"] - mean["A"],
                range_A=max(vals["A"]) - min(vals["A"]),
                range_B=max(vals["B"]) - min(vals["B"]))
    for k, v in summary.items():
        print(k, json.dumps(v))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(A=str(a), B=str(b), runs=runs,
                                            summary=summary), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
