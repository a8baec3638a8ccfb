"""The measurement entry points refuse to run without a GPU: bench.py and
chip_smoke.py exit non-zero and print no result (no silent CPU fallback)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--bounce"], ["--scaling", "--devices", "1"]])
def test_bench_exits_without_gpu(argv):
    with pytest.raises(SystemExit) as e:
        bench.run_cli(argv)
    assert e.value.code not in (0, None)
    assert "no GPU" in str(e.value.code)


@pytest.mark.parametrize("argv", [[], ["--cards", "4"]])
def test_chip_smoke_returns_nonzero_without_gpu(argv, capsys):
    assert chip_smoke.main(argv) == 1
    out, err = capsys.readouterr()
    assert out == "" and "needs a GPU" in err


def _no_result_line(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return "ok" not in json.loads(lines[-1])
    except json.JSONDecodeError:
        return True


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_script_fails_without_gpu(tmp_path, alone):
    """As a script: in the checkout, and copied alone into an empty
    directory (where the program itself is missing)."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert _no_result_line(r.stdout)
