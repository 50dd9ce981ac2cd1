"""The port's sharding tables (``repro_torch.launch.sharding``) against the
reference's ``NamedSharding`` specs.

For every one of the 42 (arch x shape) cells, each argument leaf's spec in
the port's cell (``repro_torch.models.api.build_cell``) must equal
``NamedSharding.spec`` of the reference's cell, leaf by leaf through the
same path names: at a 1 x 1 mesh in this process, and at the production
16 x 16 and 2 x 16 x 16 meshes in a subprocess that builds the reference's
cells over 512 host devices (``--xla_force_host_platform_device_count``,
which must be set before JAX starts).  On one card nothing shards:
``layers.shard_hint`` stays the identity (``tests/test_torch_lm.py``).
"""
import json
import os
import subprocess
import sys

import jax
import torch
from jax.sharding import NamedSharding

from repro.configs import get_arch as j_arch
from repro.configs import list_archs as j_list
from repro.launch.mesh import _axis_type_kw
from repro.models import api as JA

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import sharding as SH
from repro_torch.models import api as TA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s.shape_id) for a in list_archs(include_anns=True)
         for s in get_arch(a).shapes]


def _jsonable(x):
    return json.loads(json.dumps(x))


def ref_specs(cell) -> dict:
    """{path: spec} of a reference cell's in_shardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        cell.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {JA.SH._path_str(path): _jsonable(tuple(ns.spec))
            for path, ns in flat}


def port_specs(cell) -> dict:
    """{path: spec} of a port cell: every tensor argument's spec, and a
    host-int argument's (the decode's cur_len) at its index."""
    out = {path: _jsonable(sp) for path, _, sp in
           SH.leaf_specs(cell.arg_specs, cell.in_shardings)}
    for i, a in enumerate(cell.arg_specs):
        if isinstance(a, int):
            out[str(i)] = _jsonable(cell.in_shardings[i])
    return out


def test_cells_cover_the_reference_sweep():
    assert list_archs(include_anns=True) == j_list(include_anns=True)
    assert len(CELLS) == 42
    assert CELLS == [(a, s.shape_id) for a in j_list(include_anns=True)
                     for s in j_arch(a).shapes]


def test_every_spec_equals_the_reference_at_1x1():
    mesh = jax.make_mesh((1, 1), ("data", "model"), **_axis_type_kw(2))
    single = SH.mesh_shape("single")
    for arch, shape in CELLS:
        want = ref_specs(JA.build_cell(j_arch(arch), shape, mesh))
        got = port_specs(TA.build_cell(get_arch(arch), shape, single))
        assert got == want, (arch, shape)


_MULTI = r"""
import json, sys
import jax
from jax.sharding import NamedSharding
from repro.configs import get_arch, list_archs
from repro.launch.mesh import make_production_mesh
from repro.models import api as JA
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    name = "2x16x16" if multi else "16x16"
    for a in list_archs(include_anns=True):
        for s in get_arch(a).shapes:
            cell = JA.build_cell(get_arch(a), s.shape_id, mesh)
            flat, _ = jax.tree_util.tree_flatten_with_path(
                cell.in_shardings,
                is_leaf=lambda x: isinstance(x, NamedSharding))
            out[f"{name}|{a}|{s.shape_id}"] = {
                JA.SH._path_str(p): list(ns.spec) for p, ns in flat}
json.dump(out, open(sys.argv[1], "w"))
"""


def test_every_spec_equals_the_reference_at_production_meshes(tmp_path):
    dump = tmp_path / "specs.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", _MULTI, str(dump)],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(dump.read_text())
    assert len(ref) == 84
    for name in ("16x16", "2x16x16"):
        mesh = SH.mesh_shape(name)
        for arch, shape in CELLS:
            got = port_specs(TA.build_cell(get_arch(arch), shape, mesh))
            assert got == _jsonable(ref[f"{name}|{arch}|{shape}"]), (
                name, arch, shape)


def test_specs_are_name_rules_over_parameters_and_moments():
    """The rules read path names: a moment gets its parameter's spec, a
    table that does not divide the devices falls back to 'model', and a
    single named axis reads as the name, as NamedSharding.spec does."""
    mesh = SH.mesh_shape("16x16")
    params = {"tables": [torch.empty(512 * 3, 4, device="meta"),
                         torch.empty(16, 4, device="meta")],
              "bot": [{"w": torch.empty(13, 8, device="meta"),
                       "b": torch.empty(8, device="meta")}]}
    specs = SH.dlrm_param_sharding(mesh, {"mu": params})
    assert specs["mu"]["tables"] == [(("data", "model"), None),
                                     ("model", None)]
    assert specs["mu"]["bot"][0] == {"w": (None, None), "b": (None,)}
    assert SH.lm_batch_sharding(mesh) == {"tokens": ("data", None),
                                          "labels": ("data", None)}
    assert SH.lm_batch_sharding(SH.mesh_shape("2x16x16"))["tokens"] == (
        ("pod", "data"), None)
    assert SH.per_device_bytes(mesh, params["tables"][0],
                               (("data", "model"), None)) == 6 * 4 * 4
