"""Training metrics written as text and CSV, and as TensorBoard events
where ``torch.utils.tensorboard`` imports (counterpart of the JAX package's
``utils/logging.py``; the WandB mirror is not carried over: the package
is not installed and runs have no network)."""

from __future__ import annotations

import csv
import os
import sys
import time
import types


def _tensorboard_without_tensorflow() -> None:
    """Make TensorBoard write through its own TF-free stub, as its
    ``no_tensorflow`` build does: the marker module
    ``tensorboard.compat.notf`` (``tensorboard/compat/__init__.py``).
    The port never uses TensorFlow, and a host that has it installed
    would otherwise import it with the writer (~12 s on a CPU).  Left
    alone once TensorFlow is loaded."""
    if "tensorflow" not in sys.modules:
        sys.modules.setdefault(
            "tensorboard.compat.notf",
            types.ModuleType("tensorboard.compat.notf"))


class MetricLogger:
    """Append-only ``train.log`` (one line a call) and ``metrics.csv``
    (its columns fixed by the first call, later keys ignored, as the JAX
    logger) under ``work_dir``; with ``use_tensorboard``, scalars under
    ``work_dir/tb`` if ``torch.utils.tensorboard`` imports."""

    def __init__(self, work_dir: str, use_tensorboard: bool = True):
        os.makedirs(work_dir, exist_ok=True)
        self.txt = open(os.path.join(work_dir, "train.log"), "a")
        self.csv_path = os.path.join(work_dir, "metrics.csv")
        self._csv = None
        self._writer = None
        self.tb = None
        if use_tensorboard:
            try:
                _tensorboard_without_tensorflow()
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(work_dir, "tb"))
            except Exception:
                self.tb = None

    def log(self, step: int, metrics: dict) -> None:
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        self.txt.write(f"[{stamp}] step {step} " + " ".join(
            f"{k}={v:.6g}" for k, v in metrics.items()) + "\n")
        self.txt.flush()
        if self._csv is None:
            new = not os.path.exists(self.csv_path)
            self._csv = open(self.csv_path, "a", newline="")
            self._writer = csv.DictWriter(
                self._csv, fieldnames=["step"] + sorted(metrics),
                extrasaction="ignore")
            if new:
                self._writer.writeheader()
        self._writer.writerow({"step": step, **metrics})
        self._csv.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, v, step)

    def close(self) -> None:
        self.txt.close()
        if self._csv is not None:
            self._csv.close()
        if self.tb is not None:
            self.tb.close()
