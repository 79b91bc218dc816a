"""The C interface of tpurt_torch's CUDA library against the ctypes
signatures in ``kernels/_build.py``.

The kernels load through ctypes, which trusts ``_build.SIGNATURES`` for
every argument: a table that disagrees with a source passes garbage
pointers, and that fails only on a card. So each ``extern "C" int
tt_*(...)`` in ``kernels/csrc/*.cu`` is parsed here and held against the
table: the number of arguments, pointer, int or float for each, and the
CUDA stream last.
"""

import re

import pytest

from tpurt_torch.kernels import _build

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(tt_\w+)\s*\(([^)]*)\)')


def _parse_sources() -> dict:
    """entry point -> list of its parameter declarations, from every
    source in csrc/."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(src.read_text()):
            assert name not in found, f"{name} defined twice"
            found[name] = [" ".join(p.split()) for p in params.split(",")]
    return found


SOURCES = _parse_sources()


def test_every_entry_point_has_a_signature_and_back():
    assert set(SOURCES) == set(_build.SIGNATURES)


@pytest.mark.parametrize("entry", sorted(_build.SIGNATURES))
def test_signature_matches_source(entry):
    """Kinds in order: a pointer parameter is 'p', an int 'i', a float
    'f'; the last parameter is the stream, a void pointer the table leaves
    implicit."""
    params = SOURCES[entry]
    *args, stream = params
    assert stream == "void* stream", (entry, stream)
    kinds = ""
    for p in args:
        if "*" in p:
            assert p.startswith(("const void*", "void*")), (entry, p)
            kinds += "p"
        elif p.startswith("float "):
            kinds += "f"
        else:
            assert p.startswith("int "), (entry, p)
            kinds += "i"
    assert kinds == _build.SIGNATURES[entry], entry


@pytest.mark.parametrize("kernel", sorted(_build.LAUNCHES))
def test_every_counted_kernel_has_an_entry_point(kernel):
    assert f"tt_{kernel}" in SOURCES
    assert f"tt_{kernel}" in _build.SIGNATURES

