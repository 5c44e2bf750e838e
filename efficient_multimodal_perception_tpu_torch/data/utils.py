"""Dataset browsing helpers (copy of the JAX package's ``data/utils.py``).

``get_loading_pipeline`` filters a pipeline config down to its loading
steps (to browse raw, un-augmented samples); ``extract_result_dict``
unwraps one term of a loaded sample dict.  The configs collapse
pipelines into loader flags (``data/nuscenes.py``), but reference-style
pipeline lists of ``{"type": ...}`` dicts are what config interop uses,
so the filter works on those.
"""

from __future__ import annotations

import torch

# ``datasets/utils.py:28-31`` — the reference's loading_functions tuple,
# plus this codebase's extra loaders (the reference registers them in
# ``pipelines/loading.py`` but its helper predates them; browsing a
# range/occ/elev config without them would drop the sample's payload).
LOADING_TYPES = frozenset(
    {
        "LoadImageFromFile",
        "LoadPointsFromFile",
        "LoadMultiViewImageFromFiles",
        "LoadPointsFromMultiSweeps",
        "DefaultFormatBundle3D",
        "Collect3D",
        # loading.py:73-174 loaders, same judgement
        "LoadRangeImageFromFile",
        "LoadOccGTFromFile",
        "LoadElevGTFromFile",
        "LoadAnnotations3D",
    }
)

# ``datasets/utils.py:38`` — wrappers whose inner pipeline is searched.
_WRAPPER_TYPES = frozenset({"MultiScaleFlipAug3D"})


def is_loading_function(transform) -> bool | None:
    """Judge whether a transform config is a loading step.

    ``datasets/utils.py:14-45``.  Returns ``None`` for the
    ``MultiScaleFlipAug3D`` wrapper (caller must recurse into its
    ``transforms``), ``True`` for loading steps, ``False`` otherwise.
    Accepts a config dict or any object with a ``type`` attribute.
    """
    if isinstance(transform, dict):
        t = transform.get("type")
    else:
        t = getattr(transform, "type", type(transform).__name__)
    if t in _WRAPPER_TYPES:
        return None
    return t in LOADING_TYPES


def get_loading_pipeline(pipeline):
    """Keep only the loading-related entries of a pipeline config.

    ``datasets/utils.py:48-108``: augmentation / normalization /
    filtering steps are dropped; ``MultiScaleFlipAug3D`` wrappers are
    flattened into their inner loading steps.  Raises if nothing
    loading-related remains (a pipeline must load *something*).
    """
    loading_pipeline = []
    for transform in pipeline:
        is_loading = is_loading_function(transform)
        if is_loading is None:  # wrapper: extract its inner pipeline
            if isinstance(transform, dict):
                inner = transform.get("transforms", [])
            else:
                inner = getattr(transform, "transforms", [])
            loading_pipeline.extend(get_loading_pipeline(inner))
        elif is_loading:
            loading_pipeline.append(transform)
    assert len(loading_pipeline) > 0, (
        "The data pipeline in your config file must include loading steps."
    )
    return loading_pipeline


def extract_result_dict(results, key):
    """Extract and unwrap the data under ``key`` in a sample dict.

    ``datasets/utils.py:111-135``.  A term may be wrapped in a list or
    tuple (its first entry is taken) and may be a torch tensor (returned
    as a numpy array); a missing key returns ``None``.
    """
    if results is None or key not in results:
        return None
    data = results[key]
    if isinstance(data, (list, tuple)):
        if len(data) == 0:
            return None
        data = data[0]
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return data
