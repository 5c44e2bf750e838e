"""The port's serving entry point on the CPU at the tiny config."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.serve import (
    BATCH_KEYS,
    InferenceWorker,
    build_infer_fn,
    make_model,
    make_server,
)
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401


@pytest.fixture(scope="module")
def tiny_model():
    model, _ = make_model("tiny_occ", device="cpu", seed=0)
    return model


def _request(n, seed):
    a = synthetic_arrays(n, point_budget=512, seed=seed)
    return {k: a[k] for k in BATCH_KEYS}


def test_worker_coalesces_two_requests(tiny_model):
    infer = build_infer_fn(tiny_model)
    template = synthetic_arrays(2, point_budget=512, seed=0)
    worker = InferenceWorker(infer, template, batch_size=2,
                             coalesce_s=30.0, device="cpu")
    reqs = [_request(1, 1), _request(1, 2)]
    slots = [worker.submit(r) for r in reqs]  # queued before the worker runs
    worker.start()
    try:
        for s in slots:
            assert s["done"].wait(120)
    finally:
        worker.stop()
    assert not worker.is_alive()
    assert worker.n_batches == 1 and worker.n_requests == 2
    assert all("error" not in s for s in slots)

    packed = {k: np.concatenate([r[k] for r in reqs]) for k in BATCH_KEYS}
    with torch.no_grad():
        logits, _, _ = tiny_model(arrays_to_batch(packed))
    want = torch.argmax(logits, -1).to(torch.int8).numpy()
    for i, s in enumerate(slots):
        assert s["pred"].shape == (1, 99, 99, 16)
        assert s["pred"].dtype == np.int8
        np.testing.assert_array_equal(s["pred"], want[i:i + 1])


def test_http_predict_and_healthz(tiny_model):
    server, worker = make_server(model=tiny_model, port=0, batch_size=2,
                                 coalesce_ms=1.0, device="cpu")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        buf = io.BytesIO()
        req = _request(1, 5)
        np.savez(buf, **req)
        r = urllib.request.urlopen(urllib.request.Request(
            base + "/predict", data=buf.getvalue(), method="POST"),
            timeout=120)
        with np.load(io.BytesIO(r.read())) as z:
            pred = z["pred"]
        with torch.no_grad():
            want = build_infer_fn(tiny_model)(arrays_to_batch(req)).numpy()
        np.testing.assert_array_equal(pred, want)

        bad = io.BytesIO()
        np.savez(bad, img=req["img"])
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                base + "/predict", data=bad.getvalue(), method="POST"),
                timeout=60)
        assert e.value.code == 400
        health = json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=60).read())
        assert health["requests"] == 1 and health["batches"] == 1
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()
