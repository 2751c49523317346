"""The port's mesh and sharding policy (launch.mesh, launch.shardings,
models.sharding, configs.SHAPES / supported_cells / input_specs) against
the JAX package's own functions, on the CPU.

The reference's policy runs on stand-in meshes (an object with the
production meshes' axis names and a devices array of their shape), so
no 256 or 512 devices are needed: its functions read nothing but
``mesh.axis_names`` and ``mesh.devices.shape``.  Every config of ARCHS
runs at full width through jax.eval_shape on the reference's side and
meta tensors on the port's, so nothing is allocated.  Everything here
is exact: paths, shapes, dtypes and specs are equal.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro import configs as rconfigs
from repro.launch import shardings as rshd
from repro.models import sharding as rsharding
from repro.models import transformer as RT
from repro.train import optimizer as ropt
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tshd
from repro_torch.models import sharding as tsharding
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as topt

ARCHS = list(tconfigs.ARCHS)
MESHES = ["16x16", "2x16x16"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS and OpenMP thread (numpy's and torch's) while this file
    runs: the suite runs its files side by side on every core."""
    with threadpool_limits(limits=1):
        yield


def _meshes(name):
    """(the reference's stand-in mesh, the port's mesh) of ``name``."""
    multi = name == "2x16x16"
    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    ref = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    port = tmesh.make_production_mesh(multi_pod=multi)
    assert (port.axis_names, port.shape) == (axes, shape)
    return ref, port


def _ref_leaves(tree):
    """(path, shape, dtype name) of every leaf of a reference tree."""
    return [(rshd._path_str(kp), tuple(leaf.shape), str(leaf.dtype))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree):
    return [(path, tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
            for path, leaf in tshd.tree_paths(tree)]


def _ref_params(arch):
    cfg = rconfigs.get(arch)
    return jax.eval_shape(lambda k: RT.init_params(k, cfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _hold_param_tree(ref_tree, port_tree):
    """Equal leaves (paths, shapes, dtypes), and on both meshes every
    leaf's port spec (tree_shardings) equal to the reference's
    param_spec."""
    leaves = _ref_leaves(ref_tree)
    assert _port_leaves(port_tree) == leaves
    for name in MESHES:
        ref_mesh, port_mesh = _meshes(name)
        want = tshd._map_with_path(lambda p, leaf: tuple(rshd.param_spec(
            p, tuple(leaf.shape), ref_mesh)), port_tree)
        assert tshd.tree_shardings(port_tree, port_mesh) == want, name
    return leaves


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    leaves = _hold_param_tree(_ref_params(arch),
                              TT.param_shapes(tconfigs.get(arch)))
    sharded = sum(any(e is not None for e in tshd.param_spec(
        p, s, _meshes("16x16")[1])) for p, s, _ in leaves)
    print(f"\n{arch}: {len(leaves)} param leaves, {sharded} sharded on "
          f"16x16")
    # every big weight is sharded somewhere
    assert sharded > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_match_reference(arch):
    ref_opt = jax.eval_shape(lambda p: ropt.init(p, ropt.OptConfig()),
                             _ref_params(arch))
    port_opt = topt.init(TT.param_shapes(tconfigs.get(arch)),
                         topt.OptConfig())
    leaves = _hold_param_tree(ref_opt, port_opt)
    # an OptState field prints as jax prints its attribute key
    assert leaves[0][0] == ".step"
    assert any(p.startswith(".mu/units/0/") for p, _, _ in leaves)


def _decode_trees(arch, shape_name):
    cfg_r, cfg_t = rconfigs.get(arch), tconfigs.get(arch)
    seq, batch, _ = tconfigs.SHAPES[shape_name]
    s_max = min(seq, cfg_t.max_seq)
    enc_r = enc_t = None
    if cfg_t.family == "encdec":
        enc_r = jax.ShapeDtypeStruct((batch, cfg_r.enc_seq, cfg_r.d_model),
                                     jnp.float32)
        enc_t = torch.empty((batch, cfg_t.enc_seq, cfg_t.d_model),
                            device="meta")
    ref = jax.eval_shape(
        lambda e: RT.init_decode_state(cfg_r, batch, s_max, e), enc_r)
    port = TT.init_decode_state(cfg_t, batch, s_max, device="meta",
                                enc_out=enc_t)
    return ref, port


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_match_reference(arch):
    cells = [c for c in tconfigs.supported_cells(arch)
             if tconfigs.SHAPES[c][2] == "decode"]
    for shape_name in cells:
        ref, port = _decode_trees(arch, shape_name)
        leaves = _ref_leaves(ref)
        assert _port_leaves(port) == leaves, shape_name
        for name in MESHES:
            ref_mesh, port_mesh = _meshes(name)
            want = tshd._map_with_path(lambda p, leaf: tuple(
                rshd.cache_spec(ref_mesh, tuple(leaf.shape))), port)
            assert tshd.cache_shardings(port, port_mesh) == want, \
                (shape_name, name)


def test_shape_grid_and_cells_match_reference():
    assert tconfigs.SHAPES == rconfigs.SHAPES
    for arch in ARCHS:
        assert tconfigs.supported_cells(arch) == \
            rconfigs.supported_cells(arch), arch
    cells = sum(len(tconfigs.supported_cells(a)) for a in ARCHS)
    assert cells == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_batch_specs_match_reference(arch):
    cfg_r, cfg_t = rconfigs.get(arch), tconfigs.get(arch)
    for shape_name in tconfigs.supported_cells(arch):
        ref = rconfigs.input_specs(cfg_r, shape_name)
        port = tconfigs.input_specs(cfg_t, shape_name)
        assert sorted(port) == sorted(ref), shape_name
        for k, s in ref.items():
            assert port[k].device.type == "meta"
            assert tuple(port[k].shape) == tuple(s.shape), (shape_name, k)
            assert str(port[k].dtype).replace("torch.", "") == \
                str(s.dtype), (shape_name, k)
        for name in MESHES:
            ref_mesh, port_mesh = _meshes(name)
            ref_specs = jax.tree.map(
                lambda s: tuple(rshd.batch_spec(ref_mesh, len(s.shape),
                                                batch_size=s.shape[0])), ref)
            assert tshd.batch_shardings(port, port_mesh) == ref_specs, \
                (shape_name, name)


def test_batch_of_one_stays_replicated():
    """long_500k's global batch of 1 cannot split over the data axes."""
    cfg = tconfigs.get("xlstm-125m")
    specs = tconfigs.input_specs(cfg, "long_500k")
    assert tuple(specs["tokens"].shape) == (1, 1)
    for name in MESHES:
        _, mesh = _meshes(name)
        assert tshd.batch_shardings(specs, mesh) == {"tokens": (None, None)}
    _, mesh = _meshes("2x16x16")
    assert tshd.batch_spec(mesh, 2, batch_size=128) == (("pod", "data"),
                                                        None)


def _ref_constraint(monkeypatch, rules, sizes, shape, axes):
    """The spec the reference's constrain hands with_sharding_constraint
    (recorded, not applied: no mesh is needed)."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    with rsharding.logical_axis_rules(rules, sizes):
        rsharding.constrain(jnp.zeros(shape), *axes)
    monkeypatch.undo()
    return seen[0] if seen else None


@pytest.mark.parametrize("shape,axes,sizes", [
    # tests/test_runtime.py's case: 6 % 4 and 10 % 4 -> both dropped
    ((6, 10), ("batch", "ffn"), {"data": 4, "model": 4}),
    ((8, 12), ("batch", "ffn"), {"data": 4, "model": 4}),
    ((4, 3, 16, 8), ("batch", None, "heads", None),
     {"pod": 2, "data": 2, "model": 16}),
    ((8, 5, 64), ("experts", "expert_cap", None), {"data": 5, "model": 16}),
])
def test_constrain_spec_matches_reference(monkeypatch, shape, axes, sizes):
    rules = (tsharding.PRODUCTION_RULES if "pod" in sizes
             else tsharding.SINGLE_POD_RULES)
    assert rules == (rsharding.PRODUCTION_RULES if "pod" in sizes
                     else rsharding.SINGLE_POD_RULES)
    want = _ref_constraint(monkeypatch, rules, sizes, shape, axes)
    with tsharding.logical_axis_rules(rules, sizes):
        got = tsharding.constrain_spec(shape, *axes)
    assert got == want
    if shape == (6, 10):
        assert got == (None, None)
    if shape == (8, 12):
        assert got == ("data", "model")
    assert tsharding.constrain_spec(shape, *axes) is None   # no rules


def test_constrain_returns_its_argument():
    x = torch.arange(12.0).reshape(3, 4)
    assert tsharding.constrain(x, "batch", "ffn") is x
    with tsharding.logical_axis_rules(tsharding.SINGLE_POD_RULES,
                                      {"data": 1, "model": 1}):
        assert tsharding.constrain(x, "batch", "ffn") is x
        assert tsharding.constrain_spec(x.shape, "batch", "ffn") == \
            (None, None)


def test_remat_scope_nests_and_restores():
    assert not tsharding.remat_active()
    with tsharding.remat_scope(True):
        assert tsharding.remat_active()
        with tsharding.remat_scope(False):
            assert not tsharding.remat_active()
        assert tsharding.remat_active()
    assert not tsharding.remat_active()


@pytest.mark.parametrize("multi,devices", [(False, 256), (True, 512)])
def test_production_mesh_refuses_to_place(multi, devices):
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    assert mesh.devices is None and mesh.size == devices
    with pytest.raises(RuntimeError) as e:
        mesh.place(torch.zeros(2))
    msg = str(e.value)
    assert f"needs {devices} devices" in msg
    assert f"has {torch.cuda.device_count()} CUDA card(s)" in msg


def test_host_mesh_is_one_device_and_places_whole():
    mesh = tmesh.make_host_mesh("cpu")
    assert (mesh.axis_names, mesh.shape, mesh.size) == (("data", "model"),
                                                        (1, 1), 1)
    assert tmesh.mesh_axis_sizes(mesh) == {"data": 1, "model": 1}
    x = torch.ones(3)
    assert torch.equal(mesh.place(x, (None,)), x)
    # every spec on it is all None: nothing is split
    assert tshd.param_spec("units/0/attn/wq", (28, 2048, 2048), mesh) == \
        (None, None, None)
    assert tshd.cache_spec(mesh, (28, 4, 80, 8, 128)) == (None,) * 5
    assert tshd.spec_ways(("data", "model"), mesh) == 1


def test_param_spec_on_the_reference_example():
    """The stand-in check of the reference on the 16x16 mesh."""
    ref_mesh, mesh = _meshes("16x16")
    shape = (28, 2048, 2048)
    want = tuple(rshd.param_spec("units/0/attn/wq", shape, ref_mesh))
    assert want == (None, "data", "model")
    assert tshd.param_spec("units/0/attn/wq", shape, mesh) == want
    assert tshd.spec_ways(want, mesh) == 256
    _, multi = _meshes("2x16x16")
    assert tshd.spec_ways((None, ("pod", "data"), "model"), multi) == 512
