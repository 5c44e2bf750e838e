"""K2 / B6 (``ops.kernels.attention`` / ``attention_bwd``) at the paths'
shapes on one card, beside PyTorch's fused attention as a yardstick.

    python -m efficient_multimodal_perception_tpu_torch.tools.attention_bench \
        [TREE ...] [--rounds 1] [--reps 10] [--no-yardsticks] [--out a.json]

With no tree it measures this checkout; with trees it runs each in a
process of its own that imports the port from that tree (and builds its
kernels there), in the order A, B, B, A for two trees, so two designs
are compared on one card.  A process runs, at each shape of
``ATTENTION_SHAPES`` on seeded inputs: the forward and, at the training
shapes, the backward against their plain twins (relative Frobenius
error, the logsumexp's max-abs error, the backward's bits on a second
call), device ms per call of each kernel they launch
(``torch.profiler``) and event ms per call; then the yardsticks of
:func:`sdpa_yardsticks`.  One JSON line per process; the last line
holds every process's results.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

# (label, paths that run it (calls per forward or step), G, Nq, Nk, hd):
# the neck's attention at serve batch 4 and train batch 2 (G = 4
# heads a sample), the MAE decoders' sr=4 attention at train batch 2
ATTENTION_SHAPES = (
    ("serve neck", {"serve": 2, "int8_serve": 2}, 16, 4096, 4096, 256),
    ("train neck", {"train": 2, "finetune": 2}, 8, 4096, 4096, 256),
    ("camera decoder", {"train": 2}, 48, 8192, 512, 24),
    ("lidar decoder", {"train": 2}, 8, 8192, 512, 24),
)
BACKENDS = ("flash", "efficient", "math")


def _events(torch, fn, calls, tries=3):
    """(kernel name, device ms per call) of what ``fn`` launches.  A trace
    without device events (CUPTI now and then hands one back) is taken
    again; after ``tries`` of them the calls are timed with CUDA events,
    as one entry."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {e.key.split("(")[0][:70]:
               e.self_device_time_total / 1e3 / calls
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
        if sum(out.values()) > 0:
            return out
    return {"cuda events: the profiler saw no device time":
            event_ms(torch, fn, calls, warmup=0)}


def event_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def timed(torch, fn, reps):
    """Event ms, device ms and device ms by kernel of ``fn``."""
    split = _events(torch, fn, max(2, reps // 2))
    return dict(event_ms=event_ms(torch, fn, reps),
                device_ms=sum(split.values()), device_ms_by_kernel=split)


def sdpa_yardsticks(torch, q, k, v, scale, dout=None, reps=10, want=None):
    """PyTorch's attention on 4-D ``(G, 1, N, hd)`` views of ``q, k, v``,
    one backend at a time, forward and (given ``dout``) backward.

    Forward: ``flash`` is ``aten._scaled_dot_product_flash_attention``
    and ``efficient`` ``aten._scaled_dot_product_efficient_attention``
    with ``compute_log_sumexp`` (both return the logsumexp, the same
    function as K2); ``math`` is ``F.scaled_dot_product_attention``
    pinned to ``SDPBackend.MATH`` (no logsumexp).  Backward: ``autograd``
    of ``F.scaled_dot_product_attention`` pinned to each backend with
    ``torch.nn.attention.sdpa_kernel``, the forward run once outside the
    timing (``retain_graph``).  A backend that refuses the shape gives
    ``None`` and its error text; none is replaced by another.  ``want``:
    ``(out, lse)`` of the kernel, to show each call computes the same
    function (relative error of its output, max-abs error of its
    logsumexp)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    pin = {"flash": SDPBackend.FLASH_ATTENTION,
           "efficient": SDPBackend.EFFICIENT_ATTENTION,
           "math": SDPBackend.MATH}
    q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
    aten = torch.ops.aten
    fwd_calls = {
        "flash": ("aten._scaled_dot_product_flash_attention",
                  lambda: aten._scaled_dot_product_flash_attention(
                      q4, k4, v4, scale=scale)[:2]),
        "efficient": ("aten._scaled_dot_product_efficient_attention",
                      lambda: aten._scaled_dot_product_efficient_attention(
                          q4, k4, v4, None, True, scale=scale)[:2]),
        "math": ("F.scaled_dot_product_attention (SDPBackend.MATH)",
                 lambda: (F.scaled_dot_product_attention(q4, k4, v4,
                                                         scale=scale), None)),
    }
    out = {}
    for tag in BACKENDS:
        call, fn = fwd_calls[tag]
        row = dict(call=call)
        try:
            with sdpa_kernel([pin[tag]]), warnings.catch_warnings(
                    record=True) as warned:
                warnings.simplefilter("always")
                o, lse = fn()
                torch.cuda.synchronize()
                if want is not None:
                    wo, wl = want
                    a, b = o.squeeze(1).float(), wo.float()
                    row["rel_err_vs_kernel"] = float(
                        (a - b).norm() / b.norm())
                    if lse is not None:
                        n = wl.shape[1]
                        row["lse_max_abs_vs_kernel"] = float(
                            (lse.squeeze(1)[:, :n].float()
                             - wl.squeeze(-1)).abs().max())
                del o, lse
                row.update(timed(torch, fn, reps))
        except RuntimeError as e:
            row.update(event_ms=None, device_ms=None,
                       error=_reason(e, warned))
        out[f"fwd_{tag}"] = row
    if dout is None:
        return out
    do4 = dout.unsqueeze(1)
    for tag in BACKENDS:
        row = dict(call="autograd of F.scaled_dot_product_attention "
                        f"(SDPBackend.{pin[tag].name})")
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4)]
        try:
            with sdpa_kernel([pin[tag]]), warnings.catch_warnings(
                    record=True) as warned:
                warnings.simplefilter("always")
                o = F.scaled_dot_product_attention(*leaves, scale=scale)
                fn = lambda o=o, leaves=leaves: torch.autograd.grad(  # noqa: E731
                    o, leaves, do4, retain_graph=True)
                fn()
                torch.cuda.synchronize()
                row.update(timed(torch, fn, reps))
        except RuntimeError as e:
            row.update(event_ms=None, device_ms=None,
                       error=_reason(e, warned))
        out[f"bwd_{tag}"] = row
        del leaves
        torch.cuda.empty_cache()
    return out


def _reason(err, warned) -> str:
    text = " | ".join([str(err)] + [str(w.message) for w in warned])
    return text[:600]


def fastest_fused(yard: dict, way: str):
    """(ms, backend) of the faster fused backend for ``way`` ("fwd" or
    "bwd"), by event ms; ``(None, None)`` if both refused."""
    rows = [(yard[f"{way}_{t}"]["event_ms"], t) for t in ("flash",
                                                          "efficient")
            if yard.get(f"{way}_{t}", {}).get("event_ms") is not None]
    return min(rows) if rows else (None, None)


def _worker(reps: int, yardsticks: bool) -> dict:
    import torch

    from efficient_multimodal_perception_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    res = {"kernels_from": str(Path(K.__file__).resolve().parents[2]),
           "card": torch.cuda.get_device_name(0), "cases": {}}
    for label, calls, G, nq, nk, hd in ATTENTION_SHAPES:
        g = torch.Generator(device=dev).manual_seed(G * nq + hd)

        def rn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(
                torch.bfloat16)

        q, k, v, do = rn(G, nq, hd), rn(G, nk, hd), rn(G, nk, hd), rn(
            G, nq, hd)
        sc = hd**-0.5
        out, lse = K.attention(q, k, v, sc)
        po, pl = K.attention_plain(q, k, v, sc)
        torch.cuda.synchronize()
        row = dict(shape=[G, nq, nk, hd], calls=calls, fwd=dict(
            rel_err=float((out.float() - po.float()).norm()
                          / po.float().norm()),
            lse_max_abs_err=float((lse - pl).abs().max()),
            **timed(torch, lambda: K.attention(q, k, v, sc), reps)))
        del po, pl
        if "train" in calls:
            args = (q, k, v, out, lse, do, sc)
            got = K.attention_bwd(*args)
            again = K.attention_bwd(*args)
            want = K.attention_bwd_plain(*args)
            row["bwd"] = dict(
                rel_err=max(float((a.float() - b.float()).norm()
                                  / b.float().norm())
                            for a, b in zip(got, want)),
                bit_identical_across_calls=all(
                    torch.equal(a, b) for a, b in zip(got, again)),
                **timed(torch, lambda: K.attention_bwd(*args), reps))
            del got, again, want
        if yardsticks:
            row["sdpa"] = sdpa_yardsticks(
                torch, q, k, v, sc, do if "train" in calls else None, reps,
                want=(out, lse))
        res["cases"][label] = row
        print(label, json.dumps(row), file=sys.stderr, flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return res


def _run_tree(tree: Path, reps: int, yardsticks: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           "--reps", str(reps)] + ([] if yardsticks else ["--no-yardsticks"])
    r = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                       text=True, timeout=1200)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: exit {r.returncode}\n{r.stderr[-4000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    if Path(res["kernels_from"]) != tree.resolve():
        raise RuntimeError(f"{tree}: imported the port from "
                           f"{res['kernels_from']}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-yardsticks", action="store_true")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    yard = not args.no_yardsticks
    if args.worker:
        print(json.dumps(_worker(args.reps, yard)))
        return 0
    trees = [t.resolve() for t in args.trees] or [
        Path(__file__).resolve().parents[2]]
    order = ([("A", trees[0]), ("B", trees[1]), ("B", trees[1]),
              ("A", trees[0])] if len(trees) == 2
             else [(str(i), t) for i, t in enumerate(trees)])
    runs = []
    for _ in range(args.rounds):
        for tag, tree in order:
            res = _run_tree(tree, args.reps, yard)
            res.update(tag=tag, tree=str(tree))
            runs.append(res)
            brief = {lab: dict(fwd_device_ms=c["fwd"]["device_ms"],
                               bwd_device_ms=c.get("bwd", {}).get(
                                   "device_ms"))
                     for lab, c in res["cases"].items()}
            print(tag, tree, json.dumps(brief), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(runs, indent=1))
    else:
        print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
