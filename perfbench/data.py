"""The cell's vectors, made on the device.

A configuration's ``data`` block names the stand-in: ``latent_dim``
standard Gaussian coordinates rotated into ``dim`` dimensions by a seeded
orthonormal basis, plus ``noise`` (a standard deviation) on every
coordinate.  Base rows and queries are drawn alike; the angle profile's
queries are base rows, as the paper samples them.  The vectors are the
configuration's data set, drawn from its ``data.seed`` as a published set
is fixed: the work of a batch (its iterations, its recall) depends on the
draw, and every run's ``--seed`` gets the same work.  The run's seed puts
the queries in its own order (and draws the check's samples).  Everything
comes from ``torch.Generator``s on the device, in a few large calls, so a
seed gives the same bits on the same device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Inputs(NamedTuple):
    base: torch.Tensor        # [n_base, dim] float32
    queries: torch.Tensor     # [n_query, dim] float32
    profile_rows: torch.Tensor  # [profile queries] int64 rows of base


def seed_bits(seed: int) -> int:
    """Any whole number as a generator seed (negative ones too)."""
    return int(seed) % 2 ** 63


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    data = cfg["data"]
    n, nq, dim, lat = cfg["n_base"], cfg["n_query"], cfg["dim"], \
        data["latent_dim"]
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(data["seed"])
    raw = torch.randn((dim, lat), generator=gen, device=device)
    # the basis is tiny: its QR runs on the host in float64, the same
    # bits on every machine
    basis = torch.linalg.qr(raw.cpu().double())[0].float().to(device)

    def draw(rows: int) -> torch.Tensor:
        z = torch.randn((rows, lat), generator=gen, device=device)
        x = torch.randn((rows, dim), generator=gen, device=device)
        return torch.addmm(x.mul_(data["noise"]), z, basis.T)

    base = draw(n)
    queries = draw(nq)
    rows = torch.randperm(n, generator=gen, device=device)[
        : cfg["profile"]["queries"]]
    order = torch.randperm(nq, device=device, generator=torch.Generator(
        device=device).manual_seed(seed_bits(seed)))
    return Inputs(base, queries[order], rows)
