"""Time kernels of two checkouts of the port on one card, alternating,
to tell a change from the spread between runs.

    python -m efficient_multimodal_perception_tpu_torch.tools.ab_trees \
        TREE_A TREE_B [--suite b5|serve] [--rounds 2] [--reps 20] \
        [--out ab.json]

Each round runs A, B, B, A, each in a process of its own that imports
the port from that tree (and builds its kernels there at first use).
Suite ``b5`` (the default) times ``epilogue_fused`` at the six train
shapes of ``triplane_range_cam`` at batch 2 and ``post_epilogue_bwd_wide``
at its two; suite ``serve`` times ``convnext_block_int8_fused`` (B10) at
the 16 ConvNeXt shapes of the two int8 serve paths and
``finite_mlp_fused`` (B9) at the three planes of ``point_triplane_occ``,
all at batch 4 (B9's pools 93% -inf, as the synthetic cloud's are).
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
}


def _call(K, name, shape, rn, g, dev):
    """The kernel call of one case, on seeded inputs."""
    import torch

    f32 = torch.float32
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
        fn = _call(K, name, shape, rn, g, dev)
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
