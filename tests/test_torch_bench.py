"""The port's headline benchmark CLI (``cli/bench.py``) against the JAX
package's root ``bench.py`` on the CPU: the same argument errors, the same
JSON keys and metric names at a tiny configuration, one line on stdout.
The throughput itself is measured on the card (PERF.md)."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from image_super_resolution_tpu_torch.cli import bench
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

ROOT = Path(__file__).resolve().parent.parent


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["--depth", "3"],
    ["--downshuffle", "2"],
    ["--family", "fast", "--downshuffle", "1"],
    ["--preset", "denoise_fullres", "--family", "sr"],
    ["--family", "gan"],
    ["--preset", "photo"],
])
def test_argument_errors_match_jax_bench(argv, capsys):
    """Each refusal exits 2 with the JAX script's message, word for word
    (the JAX script fails before it imports JAX)."""
    jax_run = subprocess.run([sys.executable, str(ROOT / "bench.py"), *argv],
                             capture_output=True, text=True, timeout=60)
    assert jax_run.returncode == 2
    want = jax_run.stderr.strip().splitlines()[-1].split("error: ", 1)[1]
    with pytest.raises(SystemExit) as exc:
        bench.main(argv)
    assert exc.value.code == 2
    got = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    assert got == want


@pytest.mark.parametrize("family,kw", [
    ("fast", {}),
    ("denoise_fast", dict(int8=True, downshuffle=1)),
])
def test_bench_line_has_the_jax_keys_and_metric(family, kw):
    """``bench()`` at batch 2, tile 8, depth 1 in both packages: the same
    keys in the same order, the same metric name and unit; ``vs_baseline``
    null in the port (its baseline was set for another device)."""
    common = dict(family=family, depth=1, width=128, batch=2, tile=8, k_long=2, **kw)
    want = _jax_bench().bench(**common)
    got = bench.bench(**common, device="cpu")
    assert list(got) == list(want) == ["metric", "value", "unit", "vs_baseline"]
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"] == "MPix/s"
    assert got["vs_baseline"] is None and isinstance(got["value"], float)


def test_cli_prints_one_stdout_line():
    """The CLI as a user runs it: exactly one stdout line, the JSON of
    ``bench()``; the diagnostics on stderr."""
    run = subprocess.run(
        [sys.executable, "-m", "image_super_resolution_tpu_torch.cli.bench", "--device", "cpu",
         "--family", "fast", "--depth", "1", "--batch", "2", "--tile", "8"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "x4_sr_output_megapixels_per_sec_per_chip"
    assert "bench config: fast depth=1 width=128 x4, batch=2, tile=8" in run.stderr
    assert '"scatter_rdb": 0, "conv3x3_int8": 0' in run.stderr  # plain versions on the CPU


def test_default_run_is_fast_then_the_sr_diagnostic(monkeypatch, capsys):
    """No ``--family``: stdout holds the ``fast`` flagship's line only; the
    reference topology's (``sr`` x4 d16 w64) follows on stderr. ``bench()``
    is recorded here: its lines are held above."""
    calls = []

    def record(**kw):
        calls.append(kw)
        return {"metric": kw["family"], "value": 1.0, "unit": "MPix/s", "vs_baseline": None}

    monkeypatch.setattr(bench, "bench", record)
    got = bench.main(["--device", "cpu", "--int8"])
    out, err = capsys.readouterr()
    assert out.splitlines() == [json.dumps(got)] and got["metric"] == "fast"
    assert [(c["family"], c["depth"], c["width"], c["tile"], c["batch"], c["scale"])
            for c in calls] == [("fast", 14, 128, 24, 256, 4), ("sr", 16, 64, 24, 256, 4)]
    assert calls[0]["int8"] and "int8" not in calls[1]
    assert err.splitlines() == ['reference-topology diagnostic: {"metric": "sr", "value": 1.0, '
                                '"unit": "MPix/s", "vs_baseline": null}']
    calls.clear()
    bench.main(["--device", "cpu", "--preset", "denoise_fullres"])
    assert [(c["family"], c["depth"], c["width"], c["tile"], c["downshuffle"])
            for c in calls] == [("denoise_fast", 6, 128, 96, 1)]


def test_bench_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--family", "fast", "--depth", "1", "--batch", "1", "--tile", "4"])
