"""The one generator of particle clouds: a traffic file's parameters and
the configuration's sizes -> particle positions, made on the device from
the seed with one `torch.Generator`.

``"kind": "jittered_lattice"``: a k^3 lattice (k = ceil(n^(1/3))) over
[lo, hi] of each side of the box, its first n sites in x-major order,
each moved by a uniform jitter of +-jitter x side / k on every axis
(bench.py's cloud at lo 0.1, hi 0.9, jitter 0.2). n is the
configuration's ``n_particles`` times the traffic's ``particle_share``.
Every seed places the same sites; the seed moves only the jitter.
"""

from __future__ import annotations

import math

import torch

KINDS = ("jittered_lattice",)


def n_particles(traffic: dict, config: dict) -> int:
    return int(round(config["n_particles"] * traffic["particle_share"]))


def positions(traffic: dict, config: dict, seed: int, device) -> torch.Tensor:
    """(n, 3) float32 positions on ``device``."""
    if traffic["kind"] not in KINDS:
        raise ValueError(f"unknown cloud kind {traffic['kind']!r}; known: {KINDS}")
    n = n_particles(traffic, config)
    side = float(config["case"]["grid"]["cube"][1])
    k = int(math.ceil(n ** (1.0 / 3.0)))
    axis = torch.linspace(traffic["lo"] * side, traffic["hi"] * side, k,
                          dtype=torch.float64, device=device)
    sites = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)[:n]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    jitter = torch.rand((n, 3), generator=gen, dtype=torch.float64, device=device)
    return (sites + (2.0 * jitter - 1.0) * (traffic["jitter"] * side / k)).to(torch.float32)
