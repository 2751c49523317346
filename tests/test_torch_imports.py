"""The port's import rule: every module under src/repro_torch imports
torch and numpy only, never jax and nothing of the JAX package (repro).
Checked in a fresh interpreter, so modules the test process already
holds do not hide an import."""
import json
import os
import pkgutil
import subprocess
import sys

import repro_torch
from repro_torch import configs as tconfigs

SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))


def _port_modules():
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return sorted(names)


def test_port_imports_no_jax_and_nothing_of_repro():
    mods = _port_modules()
    assert "repro_torch.launch.train" in mods
    assert "repro_torch.train.optimizer" in mods
    for m in ("calib.plan", "calib.__main__", "core.cost",
              "signed.recompose", "models.moe", "configs.mixtral_8x7b",
              "configs.llama4_scout_17b_a16e", "models.recurrent",
              "configs.gemma_7b", "configs.minitron_8b",
              "configs.nemotron_4_340b", "configs.recurrentgemma_2b",
              "configs.xlstm_125m", "configs.whisper_small",
              "configs.internvl2_76b", "app", "app.sharpening",
              "app.edge_detection", "app.tables", "core.metrics",
              "launch.mesh", "launch.shardings", "launch.dryrun",
              "models.sharding"):
        assert "repro_torch." + m in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith('jax.') or n == 'jaxlib'\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_dryrun_import_leaves_xla_flags_unset():
    """The reference's dry run forces 512 host devices through XLA_FLAGS
    before jax starts; the port's needs no device and sets nothing."""
    code = ("import os\n"
            "import repro_torch.launch.dryrun\n"
            "print(repr(os.environ.get('XLA_FLAGS')))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "None"


def test_port_serves_every_config_of_the_reference():
    """configs.ARCHS lists every config the JAX package has (the
    reference's registry read as its source text: importing it would
    pull jax into this process)."""
    import ast
    path = os.path.join(SRC, "repro", "configs", "__init__.py")
    tree = ast.parse(open(path).read())
    ref = next(ast.literal_eval(n.value) for n in tree.body
               if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "ARCHS" for t in n.targets))
    assert sorted(tconfigs.ARCHS) == sorted(ref)
    assert len(tconfigs.ARCHS) == len(set(tconfigs.ARCHS))
