"""The benchmark's manifest (``BENCHMARK.json``) against the form its
runner accepts: every free-text string (a configuration's ``source`` and
``why``, a cell's ``why``, a metric's ``layer``) is 1 to 200 printable
ASCII characters on one line, every name is made of the allowed
characters, every unit too, each entry has only its own keys, and every
file an entry names is in the checkout. One case per entry."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
TEXT = {"configs": ("source", "why"), "workloads": ("why",), "end_to_end": (),
        "per_layer": ("layer",)}
ENTRIES = [(kind, e) for kind in KEYS for e in BENCH[kind]]


def printable_line(text) -> bool:
    """1 to 200 characters, each printable ASCII (space to tilde): no tab,
    no newline, nothing beyond ASCII."""
    return isinstance(text, str) and 1 <= len(text) <= 200 and all(
        " " <= ch <= "~" for ch in text)


@pytest.mark.parametrize("kind,entry", ENTRIES, ids=[f"{k}:{e['name']}" for k, e in ENTRIES])
def test_entry_has_the_accepted_form(kind, entry):
    for key in TEXT[kind]:
        assert printable_line(entry[key]), (key, entry[key])
    assert NAME.match(entry["name"]), entry["name"]
    extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
    assert KEYS[kind] <= set(entry) <= KEYS[kind] | extra, sorted(entry)
    if kind == "configs":
        assert (ROOT / entry["file"]).is_file()
        assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    if kind == "workloads":
        assert entry["config"] in {c["name"] for c in BENCH["configs"]}
        assert NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
        assert (ROOT / "perfbench" / "traffic" / f"{entry['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "cells" / f"{entry['name']}.json").is_file()
    if kind in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        cells = {w["name"] for w in BENCH["workloads"]}
        assert set(entry.get("workloads", cells)) <= cells
    if kind == "per_layer":
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert (ROOT / "perfbench" / "metrics" / f"{entry['name']}.py").is_file()


def test_names_are_unique_and_the_file_is_small():
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert all(printable_line(word) for word in BENCH["command"])
