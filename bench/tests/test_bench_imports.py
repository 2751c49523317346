"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level name; the harness refuses to run without a card."""
import subprocess
import sys

from bench import harness


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchx_probe", sys)
    assert "repro_torchx_probe" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.probe", sys)
    assert "repro.probe" in harness.forbidden_loaded()


def test_a_cpu_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = ['.', 'bench/tests', 'src']\n"
        "from _smoke import run_cell\n"
        "from bench import harness\n"
        "run_cell('minitron-8b.eval-prompt', trace=True)\n"
        "run_cell('minitron-8b.qat-train', trace=True)\n"
        "import bench.control\n"
        "print(harness.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    code = ("import torch; torch.cuda.is_available = lambda: False; "
            "import runpy, sys; sys.argv = ['run.py', '--workload', "
            "'minitron-8b.eval-prompt', '--seed', '1', '--seconds', '1']; "
            "runpy.run_path('bench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 3
    assert out.stdout == ""
