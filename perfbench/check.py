"""The comparison that decides ``correct``.

The side under test (the program, or the control) hands over what its
set-up and its timed path produced: the K-NN graph (neighbour ids and edge
lengths), the angle profile's samples, and its answers: every request of
the window as the rows of the query set it asked for, their ids,
distances and per-query counters (``answers`` folds them into the first
answer to each query, and counts the later answers that differ from it).
Each number below is compared with its limit in the configuration's
``check.limits``; the readings that set each limit are in PERF.md.  Every
distance is a rank under the configuration's ``metric`` (``reference.py``),
on rows as the metric takes them (normalised under ``cosine``).  A
configuration that the reference cannot judge is refused before any
set-up (``judgeable``).

* ``bad_rows``: queries whose answer has an id out of range, an id twice,
  or distances out of order (exact: limit 0);
* ``answers_differ``: answers whose ids, distances or counters differ
  from the first answer to the same query (exact: limit 0);
* ``dist_err``: over every query answered, the largest relative gap between a
  returned distance and the exact (float64) rank of the returned id: under
  ``l2`` relative to that squared distance, under ``ip`` and ``cosine``,
  whose ranks reach zero and go negative, relative to |q|·|x|;
* ``graph_ids_off``: over a sample of graph rows drawn from the seed, the
  share of neighbour ids that are not among the row's exact k nearest;
* ``edge_len_err``: over the same rows, the largest relative gap between
  a stored edge length and the exact one;
* ``angle_ks``: the Kolmogorov-Smirnov distance between the side's angle
  samples and the reference's (the same profile queries, searched on the
  side's graph with exact distances);
* ``query_mismatch``: over a sample of the queries answered, drawn from
  the seed, the
  share whose ids or counters differ from the reference search's (on the
  side's graph, the reference's own entry point, edge lengths, threshold
  and SQ8 tables).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from perfbench import reference as R
from perfbench.data import Inputs, seed_bits


class Request(NamedTuple):
    rows: np.ndarray        # [b] rows of the query set asked for
    ids: np.ndarray         # [b, k] (-1: empty)
    dists: np.ndarray       # [b, k] ranks
    counters: Dict[str, np.ndarray]   # [b] each, reference.COUNTERS


class Answers(NamedTuple):
    rows: np.ndarray        # [Q] the query rows answered, ascending
    ids: np.ndarray         # [Q, k] the first answer to each (-1: empty
                            # or out of range)
    dists: np.ndarray       # [Q, k]
    counters: Dict[str, np.ndarray]   # [Q] each
    times: np.ndarray       # [Q] answers each query got
    differ: np.ndarray      # [Q] answers that differ from the first


class Side(NamedTuple):
    nbrs: np.ndarray        # [n, M] neighbour ids
    edges: np.ndarray       # [n, M] edge lengths
    angles: np.ndarray      # the profile's angle samples (radians)
    answers: Answers


def answers(requests, n_query: int, n: int) -> Answers:
    """The first answer to each query the requests asked for, how many
    answers each got, and how many of them differ from the first."""
    k = requests[0].ids.shape[1]
    ids = np.full((n_query, k), -1, np.int64)
    dists = np.full((n_query, k), np.inf, np.float64)
    counters = {c: np.zeros(n_query, np.int64) for c in requests[0].counters}
    times = np.zeros(n_query, np.int64)
    differ = np.zeros(n_query, np.int64)
    for r in requests:
        rid = np.where((r.ids >= 0) & (r.ids < n), r.ids, -1)
        rows, first = np.unique(r.rows, return_index=True)
        new = times[rows] == 0
        rows, first = rows[new], first[new]
        ids[rows], dists[rows] = rid[first], r.dists[first]
        for c, v in r.counters.items():
            counters[c][rows] = v[first]
        bad = ((ids[r.rows] != rid).any(1)
               | ~(dists[r.rows] == r.dists).all(1))
        for c, v in r.counters.items():
            bad |= counters[c][r.rows] != v
        np.add.at(differ, r.rows, bad)
        np.add.at(times, r.rows, 1)
    rows = np.flatnonzero(times)
    return Answers(rows, ids[rows], dists[rows],
                   {c: v[rows] for c, v in counters.items()}, times[rows],
                   differ[rows])


def judgeable(cfg: dict) -> None:
    """Raises ``ValueError`` for a configuration that the reference cannot
    judge: a metric outside ``reference.METRICS``, a graph other than the
    exact K-NN graph (``graph_ids_off`` takes it to be exact), or a router
    outside ``reference.ROUTERS``."""
    for what, got, known in (("metric", cfg["metric"], R.METRICS),
                             ("graph.kind", cfg["graph"]["kind"], ("knn",)),
                             ("search.router", cfg["search"]["router"],
                              R.ROUTERS)):
        if got not in known:
            raise ValueError(f"the benchmark cannot judge {what} {got!r}: "
                             f"its reference knows {known}")


def ks_distance(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.sort(a), np.sort(b)
    v = np.concatenate([a, b])
    fa = np.searchsorted(a, v, side="right") / len(a)
    fb = np.searchsorted(b, v, side="right") / len(b)
    return float(np.max(np.abs(fa - fb)))


def _sample(seed: int, salt: int, n: int, m: int) -> np.ndarray:
    rng = np.random.default_rng([seed_bits(seed), salt])
    return np.sort(rng.choice(n, size=min(m, n), replace=False))


def rows_block(dim: int, lanes: int) -> int:
    """Rows a block so that one float64 tile of ``lanes`` rows a query
    stays near 256 MB."""
    return max(1, 2 ** 28 // (lanes * dim * 8))


def recall(ids: np.ndarray, gt: np.ndarray, times: np.ndarray) -> float:
    """Mean over answers of |found ∩ exact top-k| / k, a query's answer
    counted as often as it was given (``times``)."""
    k = gt.shape[1]
    hit = (ids[:, :, None] == gt[:, None, :]).any(-1).sum(1)
    return float((hit * times).sum() / (times.sum() * k))


def results_readings(inputs: Inputs, side: Side, cfg: dict):
    """The readings of the answers, and which queries' answers are bad."""
    metric = cfg["metric"]
    dev = inputs.base.device
    n = inputs.base.shape[0]
    a = side.answers
    ids = torch.as_tensor(a.ids, device=dev).long()
    dists = torch.as_tensor(a.dists, device=dev).double()
    valid = (ids >= 0) & (ids < n)
    srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(
        ids.shape[1], device=dev)), dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    unordered = ~(dists[:, 1:] >= dists[:, :-1]).all(1)
    bad = (~valid).any(1) | dup | unordered | ~torch.isfinite(dists).all(1)
    x64 = R.rows_in(inputs.base, "fp64", metric)
    q64 = R.rows_in(inputs.queries[torch.as_tensor(a.rows, device=dev)],
                    "fp64", metric)
    block = rows_block(x64.shape[1], ids.shape[1])
    err = 0.0
    for s in range(0, ids.shape[0], block):
        i, v = ids[s: s + block], valid[s: s + block]
        q, x = q64[s: s + block], x64[torch.where(v, i, 0)]
        true = R.rank(q, x, metric)
        if metric == "l2":
            scale = true
        else:
            scale = (torch.linalg.norm(q, dim=1)[:, None]
                     * torch.linalg.norm(x, dim=-1))
        gap = (dists[s: s + block] - true).abs() / torch.clamp_min(scale,
                                                                   1e-30)
        gap = torch.where(torch.isnan(gap), float("inf"), gap)
        err = max(err, float(torch.where(v, gap, 0.0).max()))
    return {"bad_rows": int(bad.sum()), "answers_differ": int(a.differ.sum()),
            "dist_err": err}, bad.cpu().numpy()


def graph_readings(inputs: Inputs, side: Side, cfg: dict, seed: int) -> dict:
    dev = inputs.base.device
    n, M = side.nbrs.shape
    rows = torch.as_tensor(_sample(seed, 1, n, cfg["check"]["graph_rows"]),
                           device=dev)
    ref, _ = R.nearest(inputs.base, inputs.base[rows], M, "fp64",
                       cfg["metric"], self_rows=rows)
    got = torch.as_tensor(side.nbrs, device=dev)[rows].long()
    off = 1.0 - float((got[:, :, None] == ref[:, None, :]).any(-1)
                      .double().mean())
    x64 = R.rows_in(inputs.base, "fp64", cfg["metric"])
    ok = (got >= 0) & (got < n)
    true = torch.sqrt(R.sq_dist(x64[rows], x64[torch.where(ok, got, 0)]))
    stored = torch.as_tensor(side.edges, device=dev)[rows].double()
    gap = (stored - true).abs() / torch.clamp_min(true, 1e-30)
    gap = torch.where(ok, gap, float("inf"))
    return {"graph_ids_off": off, "edge_len_err": float(gap.max())}


def search_readings(inputs: Inputs, side: Side, cfg: dict, seed: int):
    """The angle profile and the hop loop, worked out again on the side's
    graph; returns the readings and the reference's threshold."""
    dev = inputs.base.device
    metric = cfg["metric"]
    n, M = side.nbrs.shape
    x64 = R.rows_in(inputs.base, "fp64", metric)
    nbrs = torch.clamp(torch.as_tensor(side.nbrs, device=dev).long(), 0, n)
    entry = R.medoid(inputs.base, "fp64", metric)
    prof = cfg["profile"]
    angles = R.profile_angles(
        x64.cpu().numpy(), side.nbrs, entry,
        x64[inputs.profile_rows].cpu().numpy(), prof["efs"], metric)
    theta = float(np.percentile(angles, prof["percentile"]))
    ed = R.edge_lengths(torch.cat([x64, torch.zeros_like(x64[:1])]), nbrs)
    x, nb, ed = R.with_pad(x64, nbrs, torch.where(nbrs < n, ed,
                                                  float("inf")))
    spec = cfg["search"]
    sq8 = (R.sq8_tables(x64) if spec["estimate"] in R.TWO_STAGE
           else None)
    a = side.answers
    p = _sample(seed, 2, len(a.rows), cfg["check"]["queries"])
    pick = torch.as_tensor(a.rows[p], device=dev)
    found = R.search_blocks(
        x, nb, ed, entry, R.rows_in(inputs.queries[pick], "fp64", metric),
        math.cos(theta), spec, metric, sq8,
        block=rows_block(x64.shape[1], spec["beam_width"] * M))
    ref_ids = torch.where(found.ids >= n, -1, found.ids)
    differs = (ref_ids.cpu().numpy() != a.ids[p]).any(1)
    for c in R.COUNTERS:
        differs |= found.counters[c].cpu().numpy() != a.counters[c][p]
    return {"angle_ks": ks_distance(side.angles, angles),
            "query_mismatch": float(differs.mean())}, theta


def judge(inputs: Inputs, side: Side, cfg: dict, seed: int):
    """Readings, each beside its limit, and ``correct``; plus what the
    reference worked out that the run reports (its threshold) and which
    queries' answers are bad."""
    readings, bad = results_readings(inputs, side, cfg)
    readings.update(graph_readings(inputs, side, cfg, seed))
    more, theta = search_readings(inputs, side, cfg, seed)
    readings.update(more)
    limits = cfg["check"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks, {"theta_ref": theta, "bad": bad}
