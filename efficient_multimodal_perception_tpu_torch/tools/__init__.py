"""Tools of the port: ``export`` (``torch.export`` serving artifacts;
``load_artifact`` loads one without the model code), ``import_torch_ckpt``
(a reference ``.pth`` into the port's checkpoint form), ``create_data``,
``create_range_images`` and ``create_elevation`` (offline nuScenes
preparation), ``fixture_world`` (a nuScenes-shaped world of files from a
seed) and the measurement scripts run on a CUDA card
(``attention_bench``, ``ab_trees``, ``ptxas_compare``)."""

from .export import load_artifact  # noqa: F401
