"""``_kernels.TABLE`` against the C sources, read as text: each entry's
symbol is defined in an ``extern "C"`` block with the parameters the table
binds, every exported ``gsl_*`` function is bound, and ``LAUNCHES`` counts
the table's launches. A mismatch would otherwise show only on the card, as
a crash or as wrong pointers; nothing here loads the library."""

import re

import pytest

from gs_localization_torch import _kernels

_EXTERN_C = re.compile(r'extern "C" \{(.*?)\}  // extern "C"', re.S)
# a definition: return type, name, parameters, then the body's brace
_DEFINITION = re.compile(r"^(?:int|const char\*) (gsl_\w+)\(([^)]*)\)\s*\{",
                         re.M)


def _exported() -> dict:
    """Every function defined in an ``extern "C"`` block of ``csrc/*.cu``:
    name -> its parameters' declarations."""
    found = {}
    for src in _kernels.sources():
        for block in _EXTERN_C.findall(src.read_text()):
            for name, params in _DEFINITION.findall(block):
                assert name not in found, f"{name} defined twice"
                found[name] = [" ".join(p.split()) for p in params.split(",")]
    return found


def _kind(param: str) -> str:
    """A parameter's kind as the table writes it: ``p`` a pointer, ``i``
    an ``int``, ``f`` a ``float`` (``?`` anything else)."""
    if "*" in param:
        return "p"
    return {"int": "i", "float": "f"}.get(param.rsplit(" ", 1)[0], "?")


EXPORTED = _exported()
INFO = sorted({e.info[1] for e in _kernels.TABLE.values() if e.info})


@pytest.mark.parametrize("name", list(_kernels.TABLE))
def test_entry_matches_its_c_definition(name):
    entry = _kernels.TABLE[name]
    assert entry.symbol in EXPORTED, f"{entry.symbol} is not exported"
    params = EXPORTED[entry.symbol]
    assert params[-1] == "void* cuda_stream", params[-1]
    assert "".join(map(_kind, params[:-1])) == entry.args, params


@pytest.mark.parametrize("symbol", INFO)
def test_info_function_matches_its_c_definition(symbol):
    assert [_kind(p) for p in EXPORTED.get(symbol, [])] == ["i", "p"]


def test_every_exported_function_is_bound():
    bound = {e.symbol for e in _kernels.TABLE.values()} | set(INFO) \
        | {"gsl_error_string"}
    assert set(EXPORTED) == bound
    assert [_kind(p) for p in EXPORTED["gsl_error_string"]] == ["i"]


def test_launches_count_the_table():
    names = [e.counter or name for name, e in _kernels.TABLE.items()]
    assert list(_kernels.LAUNCHES) == list(dict.fromkeys(names))
    assert set(_kernels.LAUNCHES) <= set(_kernels.TABLE)
