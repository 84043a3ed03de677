"""benchmarks/run_all.py reports a failed config through its exit code."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import run_all  # noqa: E402


@pytest.mark.parametrize("modules, want", [
    (["fine_config"], 0),
    (["fine_config", "broken_config", "fine_config"], 1),
])
def test_run_all_exit_code(tmp_path, monkeypatch, capsys, modules, want):
    (tmp_path / "fine_config.py").write_text("print('{\"ok\": 1}')\n")
    (tmp_path / "broken_config.py").write_text(
        "raise RuntimeError('config failed')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(run_all, "QUICK", modules)
    assert run_all.main(["--quick"]) == want
    err = capsys.readouterr().err
    assert ("broken_config FAILED" in err) == bool(want)
