"""How `correct` is decided: the program's own outputs against the plain
reference, each number against its limit.

The reference cannot follow the program over a whole run (the coupled
system amplifies rounding), so it follows one chunk that the timed path
ran: from the program's state before that chunk it runs the chunk's
steps itself, in float64, and each output the chunk produced is compared
with its own: the exchange's volume fraction, particle velocity field,
explicit source and drag coefficient (its particle force and torque
through the velocities they drive), the DEM's displacements and velocity
changes, kEqn's change of k, and PIMPLE's change of u, its pressure and
its face fluxes. The start, which that skips, is checked by itself: the
volume fraction of the program's first exchange against the reference's
from the same particles. Each number is a relative gap
||program - reference|| / ||reference||.

Positions are held in float32, as configured, and the program's and the
reference's differ in their last bits after a step or two. A particle that
sits on a cell face within those bits then lies in one cell for the one
and in the next for the other: a tie, in which both are right. At 1M
particles one step in about a hundred has one, and it moves the chunk's
numbers by up to a few 1e-2. So where a number is past its limit, the
reference is run again with each of its ties (`MAX_TIES` at most, whose
particles' velocities the program ended farthest from the reference's)
located across its face, and the first run that puts every number within
its limit is the one judged.
"""

from __future__ import annotations

import importlib

import torch

CHUNK_NAMES = ("alpha_p", "u_particle", "u_source", "u_source_drag", "dpos", "dvel", "dk",
               "du", "p", "phi")
NAMES = ("alpha_p_init",) + CHUNK_NAMES
MAX_TIES = 6


def rel_gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.double()
    num = float(torch.linalg.vector_norm(x - ref))
    den = float(torch.linalg.vector_norm(ref))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def reference_module(config: dict):
    return importlib.import_module(f"cfdbench.reference.{config['reference']}")


def program_state(sim, dtype=torch.float64) -> dict:
    """The arrays of a program SimState that the reference starts from."""
    fs, ps, tb = sim.fluid, sim.particles, sim.turb
    return {"u": fs.u.to(dtype), "p": fs.p.to(dtype), "phi": tuple(f.to(dtype) for f in fs.phi),
            "alpha": fs.alpha.to(dtype), "k": tb.k.to(dtype), "nut": tb.nut.to(dtype),
            "pos": ps.pos.to(dtype), "vel": ps.vel.to(dtype), "angvel": ps.angvel.to(dtype),
            "radius": ps.radius.to(dtype), "active": ps.active,
            "contact_f": ps.contact_f.to(dtype), "contact_t": ps.contact_t.to(dtype),
            "dt": float(sim.dt)}


def _min_image(d: torch.Tensor, config: dict) -> torch.Tensor:
    side = float(config["case"]["grid"]["cube"][1])
    per = torch.tensor(config["case"]["dem"]["periodic"], device=d.device)
    return torch.where(per, d - side * torch.round(d / side), d)


def chunk_readings(config: dict, start: dict, out: dict, ref: dict) -> dict:
    """The chunk's numbers: ``out`` (program or control, arrays named as
    the reference's) against ``ref``, both from ``start``."""
    def mean_free(p):
        return p - p.mean()

    return {
        "alpha_p": rel_gap(1.0 - out["alpha"], 1.0 - ref["alpha"]),
        "u_particle": rel_gap(out["u_particle"], ref["u_particle"]),
        "u_source": rel_gap(out["u_source"], ref["u_source"]),
        "u_source_drag": rel_gap(out["u_source_drag"], ref["u_source_drag"]),
        "dpos": rel_gap(_min_image(out["pos"] - start["pos"], config),
                        _min_image(ref["pos"] - start["pos"], config)),
        "dvel": rel_gap(out["vel"] - start["vel"], ref["vel"] - start["vel"]),
        "dk": rel_gap(out["k"] - start["k"], ref["k"] - start["k"]),
        "du": rel_gap(out["u"] - start["u"], ref["u"] - start["u"]),
        "p": rel_gap(mean_free(out["p"]), mean_free(ref["p"])),
        "phi": rel_gap(torch.cat([f.reshape(-1) for f in out["phi"]]),
                       torch.cat([f.reshape(-1) for f in ref["phi"]])),
    }


def program_outputs(sim) -> dict:
    fs, ps, tb = sim.fluid, sim.particles, sim.turb
    return {"alpha": fs.alpha, "u_particle": fs.u_particle, "u_source": fs.u_source,
            "u_source_drag": fs.u_source_drag, "pos": ps.pos, "vel": ps.vel, "k": tb.k,
            "u": fs.u, "p": fs.p, "phi": fs.phi}


def tie_candidates(ref: dict, prog: dict) -> list:
    """(step, particle, axis, delta) of the reference's ties, those whose
    particle's velocity the program ended farthest from the reference's
    first (a particle located a cell over is driven by another force),
    the latest step first among one particle's, `MAX_TIES` at most."""
    gap = torch.linalg.vector_norm(prog["vel"].double() - ref["vel"].double(), dim=-1)
    rows = [(float(gap[i]), step, int(i), int(a), int(d)) for step, idx, axis, delta in ref["ties"]
            for i, a, d in zip(idx.tolist(), axis.tolist(), delta.tolist())]
    rows.sort(key=lambda r: (-r[0], -r[1]))
    return [r[1:] for r in rows[:MAX_TIES]]


def resolve_tie(config: dict, start: dict, prog: dict, n_steps: int, ref: dict, values: dict,
                limits: dict):
    """The numbers against the reference run again with each tie of
    `tie_candidates` located across its face, the first that puts every
    number within its limit. -> (numbers, the tie) or, where none does,
    (``values``, None)."""
    ref_mod = reference_module(config)
    for cand in tie_candidates(ref, prog):
        alt = dict(values, **chunk_readings(
            config, start, prog, ref_mod.run_chunk(config, start, n_steps, shift=cand)))
        if judge(alt, limits):
            return alt, list(cand)
    return values, None


def readings(config: dict, n_steps: int, pos0, radius: float, alpha0, prev, final,
             limits: dict, control: bool = False):
    """Every number compared: the start (``alpha0``, the program's first
    volume fraction, from positions ``pos0``) and the chunk from the
    program state ``prev`` to ``final``, ``n_steps`` steps, with a tie
    resolved where one puts a number past its limit. With ``control``,
    also the control's numbers from the same start and chunk start: the
    reference in float32 with every array it writes stored in bfloat16,
    put in the program's place. -> (numbers, control's or None, the tie
    that was resolved or None)."""
    ref_mod = reference_module(config)
    dev = final.fluid.p.device
    pos = pos0.to(dev)
    r64 = torch.full((pos.shape[0],), radius, dtype=torch.float64, device=dev)
    init = ref_mod.initial_fields(config, pos, r64)["alpha"]
    out = {"alpha_p_init": rel_gap(1.0 - alpha0.to(dev), 1.0 - init)}
    start = program_state(prev)
    ref = ref_mod.run_chunk(config, start, n_steps)
    prog = program_outputs(final)
    out.update(chunk_readings(config, start, prog, ref))
    tie = None
    if not judge(out, limits):
        out, tie = resolve_tie(config, start, prog, n_steps, ref, out, limits)
    if not control:
        return out, None, tie
    low = torch.bfloat16
    ctl0 = ref_mod.initial_fields(config, pos, r64.float(), dtype=torch.float32, store=low)
    ctl = {"alpha_p_init": rel_gap(1.0 - ctl0["alpha"], 1.0 - init)}
    ctl_out = ref_mod.run_chunk(config, program_state(prev, torch.float32), n_steps, store=low)
    ctl.update(chunk_readings(config, start, ctl_out, ref))
    return out, ctl, tie


def judge(values: dict, limits: dict) -> bool:
    """Every number within its limit (a NaN is not)."""
    return all(values[k] <= limits[k] for k in NAMES)
