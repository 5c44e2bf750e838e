"""Time the serve forward and the training step of two checkouts of the
port on one card, alternating, to tell a change in the host's dispatch
from the spread between runs.

    python -m efficient_multimodal_perception_tpu_torch.tools.ab_paths \
        TREE_A TREE_B [--rounds 1] [--out ab_paths.json]

Each round runs A, B, B, A, each in a process of its own that imports
the port from that tree (and builds its kernels there at first use).  A
process times, on seeded weights and synthetic batches:

* ``serve_ms``: full-width ``triplane_occ`` in bf16 through
  ``serve.build_infer_fn`` at batch 4 (20 calls after 3, synchronised
  at the end: the host's dispatch included);
* ``train_ms``: a ``triplane_range_cam`` step through
  ``Trainer.train_step`` at batch 2 (5 steps after 2, each synchronised);
* ``dispatch_us``: host microseconds a call of ``ops.kernels.convnext_block``
  (K1 under ``torch.no_grad``) at a shape small enough that the card
  waits on the host (one 8 x 8 image of 96 channels; 300 calls after
  20).

It prints one JSON line a process, then the means of each tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def _worker() -> dict:
    import torch

    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        arrays_to_batch, synthetic_arrays, synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model)
    from efficient_multimodal_perception_tpu_torch.ops import kernels as K
    from efficient_multimodal_perception_tpu_torch.serve import (
        build_infer_fn, make_model)
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer)

    def wall_ms(fn, n, warm, sync_each=False):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    dev = torch.device("cuda")
    out = {}
    model, cfg = make_model("triplane_occ", dtype=torch.bfloat16,
                            device=dev, seed=0)
    infer = build_infer_fn(model)
    batch = arrays_to_batch(synthetic_arrays(
        4, point_budget=cfg["data"]["point_budget"], seed=0), dev)
    out["serve_ms"] = wall_ms(lambda: infer(batch), 20, 3)
    del model, infer, batch

    cfg = get_config("triplane_range_cam")
    model = build_model(cfg["model"], device=dev, dtype=torch.bfloat16,
                        seed=0)
    trainer = build_trainer(cfg, model, total_steps=100, seed=0)
    batch = synthetic_batch(2, point_budget=cfg["data"]["point_budget"],
                            seed=0, device=dev)
    out["train_ms"] = wall_ms(lambda: trainer.train_step(batch), 5, 2,
                              sync_each=True)
    del model, trainer, batch

    g = torch.Generator(device=dev).manual_seed(0)
    C = 96
    x = torch.randn(1, 8, 8, C, generator=g, device=dev).to(torch.bfloat16)
    p = [torch.randn(s, generator=g, device=dev) * 0.1 for s in (
        (C, 1, 7, 7), (C,), (C,), (C,), (4 * C, C), (4 * C,), (C, 4 * C),
        (C,), (C,))]
    with torch.no_grad():
        out["dispatch_us"] = wall_ms(lambda: K.convnext_block(x, *p), 300,
                                     20) * 1e3
    out["device"] = torch.cuda.get_device_name(0)
    return out


def _run_tree(tree: Path) -> dict:
    """One worker on ``tree``: this file run as a script, the port
    imported from ``tree`` (a tree without this tool works too)."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    res = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker"],
        cwd=tree, env=env, capture_output=True, text=True, timeout=1200)
    if res.returncode:
        raise RuntimeError(f"{tree}: {res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker()))
        return 0
    a, b = (Path(t).resolve() for t in args.trees)
    runs = []
    for _ in range(args.rounds):
        for tag, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
            row = dict(tree=tag, **_run_tree(tree))
            print(json.dumps(row), flush=True)
            runs.append(row)
    means = {t: {k: sum(r[k] for r in runs if r["tree"] == t)
                 / sum(r["tree"] == t for r in runs)
                 for k in ("serve_ms", "train_ms", "dispatch_us")}
             for t in ("A", "B")}
    print(json.dumps({"A": str(a), "B": str(b), "means": means}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(runs=runs, means=means), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
