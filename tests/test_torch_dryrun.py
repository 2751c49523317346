"""The port's dry run (launch.dryrun) and train --mesh against the JAX
package, on the CPU.

  * analytic_flops equals the reference's, as floats, for every arch x
    supported cell under the dry run's residual_xla rank 16 and 'xla'.
  * argument_bytes_per_device equals, as an integer, the sum the
    reference's own policy gives over its jax.eval_shape trees (param_spec
    on params and optimizer state, cache_spec on the decode state,
    batch_spec on the inputs), the counterpart of XLA's
    argument_size_in_bytes, for every cell on both production meshes.
  * The CLI runs all 32 cells of each mesh and writes one JSON record a
    cell.
  * train --mesh host trains as the run outside the mesh's rules (equal
    losses); single and multi exit at parse time with the reason.
make_prefill_logits is held in tests/test_torch_prefill_logits.py.
"""
import importlib
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro import configs as rconfigs
from repro.launch import shardings as rshd
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.train import optimizer as ropt
import repro_torch
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.quant import QuantConfig as TQ

ARCHS = list(tconfigs.ARCHS)
SRC = os.path.dirname(os.path.dirname(os.path.abspath(
    repro_torch.__file__)))
KEYS = ("arch", "shape", "kind", "mesh", "design", "backend", "rank",
        "n_devices", "model_params", "active_params", "flops_analytic",
        "microbatches", "argument_bytes_per_device")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS and OpenMP thread (numpy's and torch's) while this file
    runs: the suite runs its files side by side on every core."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def rdryrun():
    """The reference's dry-run module.  Its first lines set XLA_FLAGS to
    force 512 host devices, which matters only before jax starts its
    backend: start it first, import, and put the variable back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def _ref_mesh(multi):
    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_flops_match_reference(rdryrun, arch):
    cfg_r, cfg_t = rconfigs.get(arch), tconfigs.get(arch)
    for kw in (dict(design="design2", backend="residual_xla", rank=16),
               dict(design="design2", backend="xla")):
        for shape_name in tconfigs.supported_cells(arch):
            want = rdryrun.analytic_flops(cfg_r, shape_name, RQ(**kw))
            got = dryrun.analytic_flops(cfg_t, shape_name, TQ(**kw))
            assert isinstance(got, float) and got == want, (shape_name, kw)


def _ref_bytes(tree, spec_of, mesh) -> int:
    """Per-device bytes of a reference tree: each leaf's bytes over the
    product of the mesh axes its spec names."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        ways = 1
        for e in spec_of(rshd._path_str(kp), leaf):
            for n in ((e,) if isinstance(e, str) else e or ()):
                ways *= sizes[n]
        nbytes = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        assert nbytes % ways == 0
        total += nbytes // ways
    return total


def _ref_argument_bytes(arch, shape_name, mesh) -> int:
    """The reference's per-device argument bytes of a cell: the arguments
    its dry run lowers the step with, sharded by its own policy."""
    cfg = rconfigs.get(arch)
    seq, batch, kind = rconfigs.SHAPES[shape_name]
    params = jax.eval_shape(lambda k: RT.init_params(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))

    def pspec(path, leaf):
        return rshd.param_spec(path, leaf.shape, mesh)

    def bspec(path, leaf):
        return rshd.batch_spec(mesh, len(leaf.shape),
                               batch_size=leaf.shape[0])

    total = _ref_bytes(params, pspec, mesh)
    if kind == "train":
        opt = jax.eval_shape(lambda p: ropt.init(p, ropt.OptConfig()),
                             params)
        total += _ref_bytes(opt, pspec, mesh)
    if kind in ("train", "prefill"):
        return total + _ref_bytes(rconfigs.input_specs(cfg, shape_name),
                                  bspec, mesh)
    enc = None
    if cfg.family == "encdec":
        enc = jax.ShapeDtypeStruct((batch, cfg.enc_seq, cfg.d_model),
                                   jnp.float32)
    state = jax.eval_shape(lambda e: RT.init_decode_state(
        cfg, batch, min(seq, cfg.max_seq), e), enc)
    total += _ref_bytes(state,
                        lambda p, leaf: rshd.cache_spec(mesh, leaf.shape),
                        mesh)
    tok = {"tokens": jax.ShapeDtypeStruct((batch, 1), jnp.int32)}
    return total + _ref_bytes(tok, bspec, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_reference_policy(arch):
    cfg = tconfigs.get(arch)
    for multi in (False, True):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        for shape_name in tconfigs.supported_cells(arch):
            got = dryrun.argument_bytes_per_device(
                dryrun.cell_arguments(cfg, shape_name), mesh)
            want = _ref_argument_bytes(arch, shape_name, _ref_mesh(multi))
            assert isinstance(got, int) and got == want, (shape_name, multi)


def test_cell_record_keeps_the_reference_keys():
    res = dryrun.analyse_cell("qwen3-1.7b", "train_4k", False)
    assert sorted(res) == sorted(KEYS)
    assert (res["n_devices"], res["mesh"], res["backend"], res["rank"]) == \
        (256, "16x16", "residual_xla", 16)
    # params, both moments and the step, 256 ways where the policy splits
    assert 0 < res["argument_bytes_per_device"] < \
        3 * 4 * res["model_params"]


@pytest.mark.parametrize("multi", [False, True])
def test_cli_runs_every_cell(tmp_path, multi):
    out = tmp_path / "dryrun"
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
            "--out", str(out)] + (["--multi-pod"] if multi else [])
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(argv, env=env, text=True, capture_output=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "dry-run complete: 32/32 cells OK"
    assert sum(line.startswith("OK   ") for line in lines) == 32
    files = sorted(os.listdir(out))
    assert len(files) == 32
    mesh = "2x16x16" if multi else "16x16"
    for f in files:
        assert f.endswith(f"__{mesh}.json"), f
        rec = json.loads((out / f).read_text())
        assert sorted(rec) == sorted(KEYS), f
        assert rec["mesh"] == mesh and rec["n_devices"] == (
            512 if multi else 256)


def test_cli_refuses_no_cell(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main([])
    assert e.value.code == 2
    assert "--arch/--shape or --all" in capsys.readouterr().err


TRAIN_ARGV = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "16",
              "--batch", "2", "--log-every", "1"]


def test_train_mesh_host_gives_the_losses_without_it():
    res = tlaunch.run(tlaunch.parse_args(TRAIN_ARGV + ["--mesh", "host"]))
    assert tlaunch.parse_args(TRAIN_ARGV).mesh == "host"     # the default
    # the same run outside the host mesh's logical axis rules
    plain = tlaunch._train(tlaunch.parse_args(TRAIN_ARGV), None,
                           torch.device("cpu"))
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert res.losses == plain.losses
    assert res.grad_norms == plain.grad_norms


@pytest.mark.parametrize("mesh,devices,shape", [("single", 256, "16x16"),
                                                ("multi", 512, "2x16x16")])
def test_train_refuses_the_production_meshes(mesh, devices, shape, capsys):
    with pytest.raises(SystemExit) as e:
        tlaunch.parse_args(TRAIN_ARGV + ["--mesh", mesh])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"the {shape} mesh of {devices} devices" in err
    assert f"this machine has {torch.cuda.device_count()} CUDA card(s)" \
        in err
