"""The ctypes binding of the Hopper kernel library against its C sources.

``gavit_tpu_torch/ops/_build.py`` binds every launcher by hand: a table
(``_SIGNATURES``) of argument and result types per exported name. The
library builds only where ``nvcc`` is, so a launcher whose C signature
changed while the table did not would show only on the card, as a wrong
argument read in silence. These tests parse the ``GAVIT_EXPORT``
definitions in ``gavit_tpu_torch/csrc/*.cu`` and hold each table entry to
its definition: the name, the number of parameters, each parameter's type
and the result's. They run without a card or a compiler.
"""

import ctypes
import re

import pytest
import torch

from gavit_tpu_torch.ops import _build


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_EXPORT = re.compile(
    r"GAVIT_EXPORT\s+([\w\s*]+?)\s*\b(gavit_\w+)\s*\(([^)]*)\)\s*\{", re.S)

# the C types the launchers use → the ctypes type that carries each
_CTYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "int": ctypes.c_int,
    "unsigned": ctypes.c_uint,
    "float": ctypes.c_float,
    "long long": ctypes.c_longlong,
    "const long long*": ctypes.POINTER(ctypes.c_longlong),
    "const char*": ctypes.c_char_p,
}


def _c_type(decl: str) -> str:
    """``'const void* qkv'`` → ``'const void*'``; a bare type stays."""
    words = decl.replace("*", " * ").split()
    if len(words) > 1 and words[-1] not in ("*", "int", "long", "float",
                                            "unsigned", "char"):
        words = words[:-1]  # the parameter's name
    return " ".join(words).replace(" *", "*")


def _exports() -> dict:
    """name → (result C type, [parameter C types]) of every definition."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in _EXPORT.findall(src.read_text()):
            assert name not in found, f"{name} defined twice"
            decls = [p for p in params.split(",") if p.strip()]
            found[name] = (_c_type(ret), [_c_type(p) for p in decls])
    return found


def test_every_export_is_bound():
    exports = _exports()
    assert len(exports) >= 20  # the parser found the launchers at all
    assert sorted(exports) == sorted(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_binding_matches_the_c_signature(name):
    ret, params = _exports()[name]
    args, res = _build._SIGNATURES[name]
    assert len(args) == len(params), (
        f"{name}: {len(args)} ctypes arguments for {len(params)} C "
        f"parameters {params}")
    for i, (arg, c) in enumerate(zip(args, params)):
        assert c in _CTYPES, f"{name}: no ctypes type known for {c!r}"
        assert arg is _CTYPES[c], (
            f"{name}: parameter {i} is {c!r} in C, bound as {arg.__name__}")
    assert res is _CTYPES[ret], f"{name}: returns {ret!r}, bound as {res}"


def test_parser_reads_a_signature():
    """The parser on a definition written in the sources' style."""
    text = ("GAVIT_EXPORT int gavit_x(const void* qkv, void* out, int n,\n"
            "                         long long sb, const long long* st,\n"
            "                         unsigned seed, float scale) {\n")
    (ret, name, params), = _EXPORT.findall(text)
    assert (name, _c_type(ret)) == ("gavit_x", "int")
    assert [_c_type(p) for p in params.split(",")] == [
        "const void*", "void*", "int", "long long", "const long long*",
        "unsigned", "float"]


@pytest.mark.parametrize("name", ["gavit_moe_fwd", "gavit_moe_bwd"])
def test_moe_launchers_take_the_group_sizes(name):
    """Kernels M and M′ walk the grouping's ``group_sizes`` [E] on the
    device, not a tile map: a parameter of that name, where
    ``ops/moe_fused.py`` passes them, and none named ``tile_group``."""
    for src in sorted(_build.CSRC.glob("*.cu")):
        for _, found, params in _EXPORT.findall(src.read_text()):
            if found == name:
                names = [p.split()[-1].lstrip("*") for p in params.split(",")]
                assert "group_sizes" in names, names
                assert "tile_group" not in names
                return
    pytest.fail(f"{name} not defined")
