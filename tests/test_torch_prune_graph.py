"""The lane counters of the hop loop's CUDA graph, on the card: a replayed
iteration counts the pruned and first-stage lanes the eager one does, on
every engine, exact and two-stage, under ``cosine``.  The CPU tests of the
same counters are in ``test_torch_profile_and_prune.py``."""
import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core.index import AnnIndex
from repro_torch.core.search import HopGraphs, _search_batch, build_search_fn
from repro_torch.core.spec import SearchSpec

ENGINES = ("torch", "unfused", "fused")
COUNTERS = ("dist_calls", "est_calls", "rerank_calls", "sq8_calls", "hops",
            "pruned", "first_stage")


@pytest.mark.gpu
@pytest.mark.parametrize("estimate", ["exact", "both"])
@pytest.mark.parametrize("engine", ENGINES)
def test_a_replayed_iteration_counts_the_lanes_the_eager_one_does(engine,
                                                                  estimate):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run chip_smoke.py on one")
    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    base = rng.standard_normal((3000, 48)).astype(np.float32)
    q = torch.as_tensor(rng.standard_normal((40, 48)).astype(np.float32),
                        device=dev)
    idx = AnnIndex.build(base, graph="knn", k=16, metric="cosine",
                         device=dev)
    spec = idx.engine_spec(SearchSpec(k=10, efs=48, router="crouting",
                                      beam_width=4, engine=engine,
                                      estimate=estimate))
    arrays, _ = build_search_fn(idx.graph, spec, device=dev)
    ct = idx.profile.cos_theta_star
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    eager = _search_batch(arrays, q, ct, spec)
    graphs = HopGraphs()
    for _ in range(2):
        with trace.call() as rec:
            res = _search_batch(arrays, q, ct, spec, graphs=graphs)
        torch.cuda.synchronize()
        for c in COUNTERS:
            assert torch.equal(getattr(res, c), getattr(eager, c)), c
    assert rec.graph_iters == rec.iters == eager.iters
    assert int(eager.pruned.sum()) > 0
    assert bool((eager.pruned <= eager.est_calls).all())
