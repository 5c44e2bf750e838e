"""Batching inference server for the occupancy models (``triplane_occ``,
``point_triplane_occ``) and the elevation model (``triplane_elev``); the
serving entry point.

One inference thread holds the model at ONE static batch size and
coalesces queued requests into it, padding the tail with the template
sample; HTTP handler threads enqueue and wait.

    python -m efficient_multimodal_perception_tpu_torch.serve triplane_occ \\
        --port 8500 --batch-size 4 --bf16 [--weights params.npz]
    python -m efficient_multimodal_perception_tpu_torch.serve triplane_occ \\
        --bf16 --checkpoint WORK_DIR/checkpoints/step_N.pt
    python -m efficient_multimodal_perception_tpu_torch.serve \\
        point_triplane_occ --bf16          # --device cpu on the CPU
    python -m efficient_multimodal_perception_tpu_torch.serve triplane_occ \\
        --bf16 --int8                      # dynamic int8 products
    python -m efficient_multimodal_perception_tpu_torch.serve \\
        triplane_elev --bf16 [--int8] [--checkpoint ...]   # f32 heights

Protocol (numpy ``.npz`` both ways):

* ``POST /predict`` -- body: npz with keys ``img, range_image,
  range_points, lidar2img, cam_resize, cam_crop, cam_flip`` and, for the
  point family, ``points`` ``(n, point_budget, D)`` and ``points_valid``
  ``(n, point_budget)``, each with a leading sample axis of size
  1..batch_size.  Response: npz with ``pred``: for the occupancy models
  the ``(n, 99, 99, 16)`` int8 argmax class volume, for the elevation
  model the ``(n, 100, 100)`` float32 heights (the JAX package's
  ``tools/export.py`` output).
* ``GET /healthz`` -- liveness, the model's class and request/batch
  counters.

``--weights`` takes an npz of a ``state_dict`` (for example
``weights.load_jax_params`` output saved with ``np.savez``);
``--checkpoint`` takes a ``checkpoints/step_<N>.pt`` that
``train/cli.py`` saved, through ``train/checkpoint.restore_params_only``;
either loads with every tensor matched (``strict``), and giving both is an
error.  Without them the model is initialised from ``--seed``.  ``--int8`` applies
``ops.quant.enable_int8`` to the config (encoders, neck and Mlp head);
it adds no parameters, so the same weights load (the elevation heads
stay in the compute dtype, as in the JAX package).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time

import numpy as np
import torch

BATCH_KEYS = ("img", "range_image", "range_points", "lidar2img",
              "cam_resize", "cam_crop", "cam_flip")
POINT_KEYS = ("points", "points_valid")


def batch_keys(model) -> tuple:
    """The request keys ``model`` needs: the point family's also carry
    the raw point cloud."""
    return BATCH_KEYS + (POINT_KEYS if getattr(model, "uses_points", False)
                         else ())


def build_infer_fn(model):
    """``batch -> (B, X, Y, Z) int8`` argmax class volume, or for the
    elevation model ``batch -> (B, X, Y) float32`` heights."""
    from .models.triplane_elev import TriplaneElev

    if isinstance(model, TriplaneElev):
        def heights(batch):
            with torch.inference_mode():
                return model(batch)[0].float()

        return heights

    def infer(batch):
        with torch.inference_mode():
            logits, _, _ = model(batch)
            return torch.argmax(logits, dim=-1).to(torch.int8)

    return infer


class InferenceWorker(threading.Thread):
    """Single consumer: coalesce queued requests into one static batch,
    pad with the template sample, run, and hand each request its slice."""

    def __init__(self, infer_fn, template: dict, batch_size: int,
                 coalesce_s: float, device, keys=BATCH_KEYS):
        super().__init__(daemon=True)
        self.infer_fn = infer_fn
        self.keys = tuple(keys)
        self.template = {k: template[k] for k in self.keys}
        self.B = batch_size
        self.coalesce_s = coalesce_s
        self.device = device
        self.q: queue.Queue = queue.Queue()
        self.n_requests = 0
        self.n_batches = 0

    def submit(self, arrs: dict) -> dict:
        """Enqueue one request of ``n <= B`` samples; the returned slot's
        ``done`` event is set once ``pred`` or ``error`` is filled in."""
        slot = {"done": threading.Event()}
        self.q.put((arrs, slot))
        return slot

    def stop(self, timeout: float = 10.0) -> None:
        self.q.put((None, None))
        self.join(timeout)

    def _pack(self, items, total):
        pad = self.B - total
        packed = {}
        for k in self.keys:
            parts = [np.asarray(a[k]) for a, _ in items]
            if pad > 0:
                parts.append(np.repeat(self.template[k][:1], pad, axis=0))
            packed[k] = np.concatenate(parts, axis=0)
        return packed

    def run(self):
        from .data.synthetic import arrays_to_batch

        while True:
            arrs, slot = self.q.get()
            if arrs is None:
                return
            items = [(arrs, slot)]
            total = len(arrs["img"])
            deadline = time.monotonic() + self.coalesce_s
            while total < self.B:
                try:
                    nxt = self.q.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if nxt[0] is None or total + len(nxt[0]["img"]) > self.B:
                    self.q.put(nxt)  # sentinel, or next round
                    break
                items.append(nxt)
                total += len(nxt[0]["img"])
            try:
                batch = arrays_to_batch(self._pack(items, total),
                                        self.device)
                pred = self.infer_fn(batch).cpu().numpy()
                off = 0
                for it_arrs, it_slot in items:
                    n = len(it_arrs["img"])
                    it_slot["pred"] = pred[off:off + n]
                    off += n
            except Exception as e:  # fault-isolate the packed batch
                for _, it_slot in items:
                    it_slot["error"] = f"{type(e).__name__}: {e}"[:300]
            for _, it_slot in items:
                it_slot["done"].set()
            self.n_requests += len(items)
            self.n_batches += 1


def make_model(cfg_name="triplane_occ", weights=None, dtype=torch.float32,
               device=None, seed: int = 0, int8: bool = False,
               checkpoint=None):
    """Build the served model: seeded init, or a saved ``state_dict``
    (``weights``, an npz) or training checkpoint (``checkpoint``, a
    ``train/cli.py`` ``step_<N>.pt``), not both; ``int8`` enables the
    dynamic int8 products."""
    from .configs import get_config
    from .models.builder import build_model
    from .ops.quant import enable_int8
    from .train.checkpoint import restore_params_only

    if weights and checkpoint:
        raise ValueError("give --weights or --checkpoint, not both")
    cfg = get_config(cfg_name)
    if int8:
        enable_int8(cfg["model"])
    model = build_model(cfg["model"], device=device, dtype=dtype, seed=seed)
    if weights:
        with np.load(weights) as z:
            sd = {k: torch.from_numpy(z[k]) for k in z.files}
        model.load_state_dict(sd, strict=True)
    if checkpoint:
        model.load_state_dict(restore_params_only(checkpoint), strict=True)
    return model, cfg


def make_server(cfg_name="triplane_occ", weights=None, port=8500,
                batch_size=4, dtype=torch.float32, coalesce_ms=5.0,
                device=None, seed: int = 0, model=None, int8: bool = False,
                checkpoint=None):
    """Build ``(ThreadingHTTPServer, worker)`` with the worker started.

    ``model`` may be passed pre-built (it then overrides ``weights``,
    ``checkpoint``, ``dtype``, ``seed`` and ``int8``); ``cfg_name`` still
    names its config, whose ``data.point_budget`` sizes the padding
    template.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from . import resolve_device
    from .configs import get_config
    from .data.synthetic import arrays_to_batch, synthetic_arrays

    dev = resolve_device(device)
    if model is None:
        model, cfg = make_model(cfg_name, weights, dtype, dev, seed, int8,
                                checkpoint)
    else:
        cfg = get_config(cfg_name)
    point_budget = cfg["data"]["point_budget"]
    keys = batch_keys(model)
    template = synthetic_arrays(batch_size, point_budget=point_budget,
                                seed=0)
    infer = build_infer_fn(model)
    infer(arrays_to_batch(template, dev))  # warm up before traffic
    worker = InferenceWorker(infer, template, batch_size,
                             coalesce_ms / 1e3, dev, keys)
    worker.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, dict(error="unknown path"))
            self._json(200, dict(
                status="ok", model=type(model).__name__,
                batch_size=batch_size,
                requests=worker.n_requests, batches=worker.n_batches,
            ))

        def do_POST(self):
            if self.path != "/predict":
                return self._json(404, dict(error="unknown path"))
            n = int(self.headers.get("Content-Length", 0))
            try:
                with np.load(io.BytesIO(self.rfile.read(n)),
                             allow_pickle=False) as z:
                    arrs = {k: z[k] for k in z.files}
            except (ValueError, OSError) as e:
                return self._json(400, dict(error=str(e)[:300]))
            missing = [k for k in keys if k not in arrs]
            if missing:
                return self._json(400, dict(error=f"missing {missing}"))
            ns = {k: arrs[k].shape[0] for k in keys}
            if len(set(ns.values())) != 1:
                return self._json(400, dict(error=f"ragged sizes {ns}"))
            if not 1 <= ns["img"] <= batch_size:
                return self._json(
                    400, dict(error=f"1..{batch_size} samples required"))
            bad = [k for k in POINT_KEYS if k in keys
                   and arrs[k].shape[1:2] != (point_budget,)]
            if bad:
                return self._json(400, dict(
                    error=f"{bad}: {point_budget} points per sample "
                          "required"))
            slot = worker.submit({k: arrs[k] for k in keys})
            slot["done"].wait()
            if "error" in slot:
                return self._json(500, dict(error=slot["error"]))
            buf = io.BytesIO()
            np.savez(buf, pred=slot["pred"])
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-npz")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    return server, worker


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("config", nargs="?", default="triplane_occ")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--weights", default=None,
                     help="npz of a state_dict")
    src.add_argument("--checkpoint", default=None,
                     help="a train/cli.py checkpoint (step_<N>.pt)")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="dynamic int8 products in the encoders, the neck "
                   "and the Mlp head")
    p.add_argument("--coalesce-ms", type=float, default=5.0)
    p.add_argument("--device", default=None)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    server, worker = make_server(
        a.config, a.weights, a.port, a.batch_size,
        torch.bfloat16 if a.bf16 else torch.float32, a.coalesce_ms,
        a.device, a.seed, int8=a.int8, checkpoint=a.checkpoint,
    )
    print(f"serving on 127.0.0.1:{server.server_address[1]} "
          "(POST /predict, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        worker.stop()


if __name__ == "__main__":
    main()
