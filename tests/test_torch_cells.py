"""The port's cells (``repro_torch.models.api``) against the reference's.

For each of the 42 (arch x shape) cells at a 1 x 1 mesh: the step name,
every argument's shape and dtype by path (the LM decode's ``cur_len`` is
a host int in the port, a () int32 array in the reference), the model
FLOPs, the reference's ``analytic_extra`` and the ``body_multiplier`` must
equal the reference's ``build_cell``; the port's arguments are meta
tensors.  ``build_smoke`` runs one reduced step of every arch on the CPU
with finite outputs.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.launch.mesh import _axis_type_kw
from repro.models import api as JA

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import sharding as SH
from repro_torch.models import api as TA

CELLS = [(a, s.shape_id) for a in list_archs(include_anns=True)
         for s in get_arch(a).shapes]


def ref_args(cell) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(cell.arg_specs)
    return {JA.SH._path_str(p): (tuple(x.shape), str(x.dtype))
            for p, x in flat}


def port_args(cell) -> dict:
    out = {}

    def visit(path, leaf):
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "meta", path
            out[path] = (tuple(leaf.shape),
                         str(leaf.dtype).removeprefix("torch."))
        else:
            assert isinstance(leaf, int), path
            out[path] = ((), "int32")
        return leaf

    SH.map_with_path(visit, cell.arg_specs)
    return out


@pytest.fixture(scope="module")
def ref_cells():
    mesh = jax.make_mesh((1, 1), ("data", "model"), **_axis_type_kw(2))
    return {(a, s): JA.build_cell(j_arch(a), s, mesh) for a, s in CELLS}


def test_every_cell_equals_the_reference(ref_cells):
    single = SH.mesh_shape("single")
    for arch, shape in CELLS:
        want = ref_cells[(arch, shape)]
        got = TA.build_cell(get_arch(arch), shape, single)
        where = (arch, shape)
        assert got.step_name == want.step_name, where
        assert port_args(got) == ref_args(want), where
        assert got.model_flops == want.model_flops, where
        assert got.analytic_extra == want.analytic_extra, where
        assert got.body_multiplier == want.body_multiplier, where
        assert got.notes == want.notes, where
        assert (got.loop_fit is None) == (want.loop_fit is None), where
        if got.loop_fit:
            assert got.loop_fit[0] == want.loop_fit[0], where
            sub, ref_sub = got.loop_fit[1](2), want.loop_fit[1](2)
            assert port_args(sub) == ref_args(ref_sub), where


def test_anns_cell_terms_are_per_hop():
    cell = TA.build_cell(get_arch("crouting-anns"), "serve_100m_gist",
                         SH.mesh_shape("single"))
    B, m, dim = 256, 32, 960
    assert cell.body_multiplier == 1.5 * 128
    assert cell.body_terms == {"flops": 2.0 * B * m * dim,
                               "bytes": float(B * m * (4 + 4 + dim * 4))}
    assert cell.arg_specs[0].shape == (1, 100_000_001, 960)


@pytest.mark.parametrize("arch", list_archs(include_anns=True))
def test_build_smoke_is_finite(arch):
    out = TA.build_smoke(get_arch(arch), device="cpu")()
    for k, v in out.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            assert torch.isfinite(v).all(), (arch, k)
    assert np.isfinite(float(out["loss"]))


def test_build_smoke_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="GPU"):
        TA.build_smoke(get_arch("gin-tu"))
