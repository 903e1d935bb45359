"""The port's profiling entry, ``python -m quflow_tpu_torch.profiling``,
the counterpart of profiling/run_profiling.py: a CPU run at --nmax 64
writes its table with the JAX harness's fields; without a card and
without --device it refuses."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from quflow_tpu_torch import profiling

ROOT = Path(__file__).resolve().parent.parent


def _jax_fields():
    """The field list of profiling/run_profiling.py, read from its
    source."""
    src = (ROOT / "profiling" / "run_profiling.py").read_text()
    block = src[src.index("fields = ["):]
    block = block[: block.index("]") + 1]
    return [w.strip().strip('"') for w in
            block.split("[", 1)[1].rstrip("]").split(",") if w.strip()]


def test_profiling_writes_its_table(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "quflow_tpu_torch.profiling", "--nmax", "64",
         "--device", "cpu", "-b", str(tmp_path / "profile")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    (table,) = tmp_path.glob("profile_cpu_z_*.txt")
    lines = table.read_text().splitlines()
    assert lines[0].split("\t") == profiling.FIELDS == _jax_fields()
    rows = [ln.split("\t") for ln in lines[1:3]]
    assert [int(r[0]) for r in rows] == [32, 64]
    assert all(float(x) > 0 for r in rows for x in r[1:])
    assert "platform: cpu" in lines


def test_profiling_sizes_and_single(tmp_path):
    assert profiling._sizes(100) == [32, 64, 100]
    assert profiling._sizes(64) == [32, 64]
    out = profiling.main(["--nmax", "32", "--device", "cpu", "-s",
                          "-b", str(tmp_path / "p")])
    assert Path(out).name.startswith("p_cpu_c_")


def test_profiling_needs_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.main(["--nmax", "32", "-b", str(tmp_path / "p")])
