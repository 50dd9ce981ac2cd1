"""The port's roofline (``repro_torch.roofline``) and its meta counter.

* ``roofline_terms`` with ``TPU_V5E`` equals the reference's on the same
  inputs, key for key (exact: the same float arithmetic).
* ``count_step`` on a dense LM forward at smoke width counts 2 x the layer
  weights x tokens plus exactly the attention tiles the port's blockwise
  loop computes (QK^T and PV, 2 x bq x bk x dh each, per head and batch
  row, for the causal tiles it does not skip).
* The dry run's two-point fit at L = 1, 2 equals a full meta count at
  L = 4, for FLOPs and both byte counts (a small LM train cell).
* ``H100_SXM`` holds the published H100 SXM5 figures, and fp32 counts at
  the non-tensor-core peak.
"""
import dataclasses
import json

import pytest
import torch

from repro.roofline.analysis import roofline_terms as j_terms
from repro.roofline.hw import TPU_V5E as J_V5E

from repro_torch.configs import ArchSpec, ShapeSpec, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as SH
from repro_torch.models import api as TA
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.roofline import H100_SXM, TPU_V5E, count_step, roofline_terms
from repro_torch.tree import tree_leaves


@pytest.mark.parametrize("args", [(1e15, 2e11, 3e9, 5e14), (2e9, 5e12, 0.0, None),
                                  (0.0, 0.0, 1e6, 1.0), (4e13, 1e9, 0.0, 4e13)])
def test_roofline_terms_equal_the_reference_on_v5e(args):
    flops, nbytes, coll, model = args
    assert dataclasses.asdict(TPU_V5E) == {**dataclasses.asdict(J_V5E),
                                           "peak_flops": None}
    assert roofline_terms(flops, nbytes, coll, TPU_V5E,
                          model_flops_per_dev=model) == j_terms(
        flops, nbytes, coll, J_V5E, model_flops_per_dev=model)


def test_h100_figures_and_dtype_peaks():
    assert H100_SXM.peak("bfloat16") == 989.4e12
    assert H100_SXM.peak("float32") == 66.9e12
    assert (H100_SXM.hbm_bw, H100_SXM.ici_link_bw, H100_SXM.hbm_bytes) == (
        3.35e12, 450e9, 80e9)
    t = roofline_terms(0.0, 3.35e12, 0.0, H100_SXM,
                       flops_by_dtype={"bfloat16": 989.4e12,
                                       "float32": 66.9e12})
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["dominant"] == "compute_s"


def _smoke_lm(n_layers=2):
    return dataclasses.replace(get_arch("granite-8b").smoke_cfg,
                               n_layers=n_layers)


def test_count_step_on_an_lm_forward_is_weights_plus_attention_tiles():
    cfg = _smoke_lm()
    B, S = 2, 64
    params = T.init_params(cfg, torch.Generator(), device="meta")
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")

    def fwd(p, t):
        with torch.no_grad():
            return T.forward(p, t, cfg)

    got = count_step(fwd, params, tokens)
    D, F, H, Hkv, dh = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                        cfg.dh)
    layer_weights = D * (H + 2 * Hkv) * dh + H * dh * D + 3 * D * F
    bq, bk = min(cfg.block_q, S), min(cfg.block_k, S)
    tiles = sum(len(L._kv_blocks(iq, bq, bk)) for iq in range(S // bq))
    attn = tiles * 2 * (2 * B * H * bq * bk * dh)
    assert got["flops"] == 2 * layer_weights * B * S * cfg.n_layers \
        + attn * cfg.n_layers
    assert sum(got["flops_by_dtype"].values()) == got["flops"]
    # every argument read once, the output written once
    n_in = sum(t.numel() * t.element_size()
               for t in tree_leaves((params, tokens)))
    assert got["bytes_min"] == n_in + B * S * D * 4
    assert got["bytes_eager"] > got["bytes_min"]


def test_two_point_fit_equals_a_full_count():
    cfg = _smoke_lm(n_layers=4)
    spec = ArchSpec("t", "lm", cfg, ())
    shape = ShapeSpec("train_t", "train", dict(seq_len=64, global_batch=2))
    cell = TA._lm_cell(spec, shape, SH.mesh_shape("single"))
    assert cell.loop_fit[0] == 4
    fit = dryrun.count_cell(cell)
    full = count_step(cell.step_fn, *cell.arg_specs)
    for key in ("flops", "bytes_min", "bytes_eager"):
        assert fit[key] == pytest.approx(full[key], rel=1e-12), key
    assert fit["flops_by_dtype"] == pytest.approx(full["flops_by_dtype"])


def test_count_step_refuses_real_tensors():
    with pytest.raises(ValueError, match="meta"):
        count_step(lambda x: x * 2, torch.ones(3))


def test_dryrun_records_one_card_and_multi_mesh_cells(tmp_path):
    out = tmp_path / "dr.json"
    assert dryrun.main(["--arch", "gin-tu", "--shape", "molecule",
                        "--mesh", "both", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    one = rec["gin-tu|molecule|single"]
    assert one["status"] == "ok" and one["collective_s"] == 0.0
    assert one["step_time_lb_s"] == max(one["compute_s"], one["memory_s"])
    assert one["hw"] == H100_SXM.name and one["model_dtype"] == "float32"
    multi = rec["gin-tu|molecule|16x16"]
    assert multi["compute_s"] is None and multi["collective_s"] is None
    assert "partitioner" in multi["terms_absent"]
    assert 0 < multi["mem_args_bytes_per_dev"] < one["arg_bytes_total"]
