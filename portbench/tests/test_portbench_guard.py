"""The benchmark's own rules, checked on its files: no JAX and no JAX
package anywhere, nothing of the program in the reference, and the names,
units and metric lists of BENCHMARK.json."""
import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imported(path: Path):
    """Top-level names of every module ``path`` imports, whole."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_reference_package(path):
    assert not set(imported(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in set(imported(path)), path


def test_forbidden_names_are_compared_whole():
    from portbench.run import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.serving.core",
                              "numpy", "jaxtyping", "reprolib"]) == []
    assert forbidden_modules(["repro.core.types", "jax.numpy", "flax",
                              "jaxlib", "repro_torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = ([m["name"] for m in metrics]
             + [w["name"] for w in bench["workloads"]]
             + [c["name"] for c in bench["configs"]]
             + [w["config"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in (metrics, bench["workloads"], bench["configs"]):
        assert len({x["name"] for x in group}) == len(group)


def test_per_layer_cells_report_what_they_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells and w in moved.get("workloads", cells), m


def test_every_cell_finds_its_files(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    for w in bench["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "cells" / f"{w['name']}.json").is_file()
        for m in metrics:
            if w["name"] in m.get("workloads", [w["name"]]):
                base = m["name"].split(".")[0]
                assert (BENCH / "metrics" / f"{base}.py").is_file()
    for c in bench["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["registry_id"]
