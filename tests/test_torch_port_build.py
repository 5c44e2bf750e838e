"""The ctypes signatures of the port's kernel library against its CUDA
sources.

``ops/_build.SIGNATURES`` gives ``ctypes`` the argument types of every C
entry point in ``csrc/*.cu``.  A count or type that disagrees with the
source is not caught by the loader: the call reads garbage registers on
the card.  Here each entry point's parameter list is read from the
``extern "C"`` blocks of the sources (no compiler needed) and held to
its signature.
"""

import ctypes
import re

import pytest

from efficient_multimodal_perception_tpu_torch.ops import _build

_ENTRY = re.compile(r"^int\s+(emp_\w+)\s*\(([^)]*)\)\s*\{", re.M)


def _ctype(param: str):
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(" ", 1)[0]
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[kind]


def _entries():
    out = {}
    for path in _build._sources()[0]:
        text = path.read_text()
        for block in text.split('extern "C" {')[1:]:
            for name, params in _ENTRY.findall(block):
                out[name] = (path.name, [_ctype(p) for p in params.split(",")
                                         if p.strip()])
    return out


def test_every_entry_point_has_a_signature():
    assert set(_entries()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_source(name):
    source, params = _entries()[name]
    assert params == _build.SIGNATURES[name], source
