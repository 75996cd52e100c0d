"""Undefined-name lint for the scripts that run on the GPU.

bench.py, chip_smoke.py and __graft_entry__.py run on the card, not in
the CPU test suite beyond their import, so a NameError in a function
body survives py_compile, import and the whole suite, and only shows
on the card. (Extracting ``flagship_config()`` once moved
RenderConfig/TrainConfig imports out of ``bench.main`` that way.) This
test does a symtable pass over each script: every name a function
references must be bound somewhere — locally, in an enclosing function
scope, at module top level, or in builtins. No execution, no card,
runs in milliseconds.
"""

import builtins
import pathlib
import symtable

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ["bench.py", "chip_smoke.py", "__graft_entry__.py"]


def _bound_names(tab):
    out = set()
    for s in tab.get_symbols():
        if s.is_local() or s.is_parameter() or s.is_imported():
            out.add(s.get_name())
    return out


def _walk(tab, enclosing, problems):
    for child in tab.get_children():
        if child.get_type() == "function":
            bound = enclosing | _bound_names(child)
            for s in child.get_symbols():
                n = s.get_name()
                if not s.is_referenced():
                    continue
                if n in bound or hasattr(builtins, n):
                    continue
                problems.append(f"{child.get_name()}(): {n}")
            _walk(child, bound, problems)
        else:
            _walk(child, enclosing, problems)


@pytest.mark.parametrize("script", SCRIPTS)
def test_driver_script_has_no_undefined_names(script):
    src = (REPO / script).read_text()
    tab = symtable.symtable(src, script, "exec")
    top = {s.get_name() for s in tab.get_symbols()}
    problems = []
    _walk(tab, top, problems)
    assert not problems, (
        f"{script} references names with no binding in any scope "
        f"(would NameError on the card): {problems}"
    )
