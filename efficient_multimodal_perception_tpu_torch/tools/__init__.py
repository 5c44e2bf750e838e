"""Tools of the port: ``export`` (``torch.export`` serving artifacts;
``load_artifact`` loads one without the model code), ``fixture_world``
(a nuScenes-shaped world of files from a seed) and the measurement
scripts run on a CUDA card (``attention_bench``, ``ab_trees``,
``ptxas_compare``)."""

from .export import load_artifact  # noqa: F401
