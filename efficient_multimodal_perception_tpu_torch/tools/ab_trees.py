"""Time the B5 training kernels of two checkouts of the port on one card,
alternating, to tell a change from the spread between runs.

    python -m efficient_multimodal_perception_tpu_torch.tools.ab_trees \
        TREE_A TREE_B [--rounds 2] [--reps 20] [--out ab.json]

Each round runs A, B, B, A, each in a process of its own that imports
the port from that tree (and builds its kernels there at first use).
A process times ``epilogue_fused`` at the six train shapes of
``triplane_range_cam`` at batch 2 and ``post_epilogue_bwd_wide`` at its
two, on the same seeded inputs in every process: device ms per call
summed over the kernels a call launches (``torch.profiler``), and ms
per call of back-to-back calls between CUDA events.  It prints one line
per process, then each kernel's ms per train step (shape times calls)
for every run, and the difference of the means beside each tree's own
range over its runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# (kernel, label, rows, width, calls per train step at batch 2)
CASES = (
    ("epilogue_fused", "camera stage1", 98304, 192, 3),
    ("epilogue_fused", "camera stage2", 24576, 384, 9),
    ("epilogue_fused", "camera stage3", 6144, 768, 3),
    ("epilogue_fused", "lidar stage1", 8192, 192, 3),
    ("epilogue_fused", "lidar stage2", 4096, 384, 9),
    ("epilogue_fused", "lidar stage3", 2048, 768, 3),
    ("post_epilogue_bwd_wide", "camera stage3", 6144, 768, 3),
    ("post_epilogue_bwd_wide", "lidar stage3", 2048, 768, 3),
)


def _worker(reps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from efficient_multimodal_perception_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    out = {"kernels_from": str(Path(K.__file__).resolve().parents[2]),
           "cases": {}}
    for name, label, M, C, _ in CASES:
        g = torch.Generator(device=dev).manual_seed(M + C)

        def rn(*shape, scale=1.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, generator=g, device=dev)
                    * scale).to(dtype)

        f32 = torch.float32
        prm = (1 + rn(C, scale=0.1, dtype=f32), rn(C, scale=0.1, dtype=f32),
               rn(4 * C, C, scale=C**-0.5), rn(4 * C, scale=0.1, dtype=f32),
               rn(C, 4 * C, scale=(4 * C)**-0.5), rn(C, scale=0.1, dtype=f32),
               torch.rand(C, generator=g, device=dev) + 0.1)
        y, gy = rn(M, C), rn(M, C, scale=0.05)
        if name == "epilogue_fused":
            fn = lambda: K.epilogue_fused(y, *prm)  # noqa: E731
        else:
            fn = lambda: K.post_epilogue_bwd_wide(y, gy, *prm)  # noqa: E731
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = {e.key.split("(")[0][:60]: e.self_device_time_total / 1e3 / reps
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out["cases"][f"{name} {label} ({M},{C})"] = {
            "device_ms": sum(kern.values()), "event_ms":
            t0.elapsed_time(t1) / reps, "device_ms_by_kernel": kern}
    return out


def _run_tree(tree: Path, reps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--worker", "--reps", str(reps)], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stderr[-4000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    if Path(res["kernels_from"]) != tree.resolve():
        raise RuntimeError(f"{tree}: imported the port from "
                           f"{res['kernels_from']}")
    return res


def _per_step(res: dict, kernel: str, key: str) -> float:
    return sum(calls * res["cases"][f"{k} {label} ({M},{C})"][key]
               for k, label, M, C, calls in CASES if k == kernel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.reps)))
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees, A and B")
    a, b = (t.resolve() for t in args.trees)
    runs = []
    for _ in range(args.rounds):
        for tag, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
            res = _run_tree(tree, args.reps)
            res["tag"] = tag
            runs.append(res)
            print(tag, json.dumps(res["cases"]), flush=True)
    summary = {}
    for kernel in ("epilogue_fused", "post_epilogue_bwd_wide"):
        for key in ("device_ms", "event_ms"):
            vals = {t: [_per_step(r, kernel, key) for r in runs
                        if r["tag"] == t] for t in "AB"}
            mean = {t: sum(v) / len(v) for t, v in vals.items()}
            summary[f"{kernel} {key} per step"] = dict(
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
