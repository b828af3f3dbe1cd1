"""The numbers that decide ``correct``, each compared with its limit.

* ``grad_err``, ``value_err``: the potential.  The value+grad that
  ``sample()`` ran, at the timed batch of chains and at states the window
  visited, against the float64 reference: the largest gradient error of a
  state over that state's largest reference component (at least 1), and the
  largest error of a value once each side's mean over the batch is taken
  off (the program may drop constants), in nats.
* ``stein_scale``, ``stein_shift``: the draws, through Stein's identities of
  the posterior p over the unconstrained latents z: E[(z_i - E z_i) d_i log
  p] = -1 and E[d_i log p] = 0, with the reference's float64 gradient at the
  window's draws.  The largest |mean((z_i - mean z_i) g_i) + 1| over the
  coordinates, and the largest |mean(g_i)| * sd(z_i) (a shift of the draws
  in posterior standard deviations).
* ``rhat_max``: the largest split R-hat of the window's unconstrained draws
  (``frozen.potential_scale_reduction``): chains that do not move read far
  above 1.
"""
from __future__ import annotations

import math

import torch

from bench_port import frozen

NUMBERS = ("grad_err", "value_err", "stein_scale", "stein_shift", "rhat_max")


def flat(parts: dict, names, lead: int) -> torch.Tensor:
    """{name: [*lead, ...]} -> [*lead, d] in float64, in ``names``' order."""
    cols = []
    for n in names:
        t = parts[n].to(torch.float64)
        cols.append(t.reshape(tuple(t.shape[:lead]) + (-1,)))
    return torch.cat(cols, -1)


def potential_numbers(prog, ref, names) -> dict:
    """prog, ref: lists of (values [C], {name: gradient [C, ...]}) at the
    same batches of states."""
    g_err, v_err = 0.0, 0.0
    for (vp, gp), (vr, gr) in zip(prog, ref):
        gp, gr = flat(gp, names, 1), flat(gr, names, 1)
        scale = torch.clamp(gr.abs().amax(-1), min=1.0)
        g_err = max(g_err, float(((gp - gr).abs().amax(-1) / scale).max()))
        vp, vr = vp.to(torch.float64), vr.to(torch.float64)
        v_err = max(v_err, float(((vp - vp.mean()) - (vr - vr.mean())).abs().max()))
    return {"grad_err": g_err, "value_err": v_err}


def stein_numbers(z: torch.Tensor, g: torch.Tensor) -> dict:
    """z, g: [M, d] float64 draws and the reference's gradient there."""
    zc = z - z.mean(0)
    scale = (zc * g).mean(0) + 1.0
    shift = g.mean(0) * z.std(0)
    return {"stein_scale": float(scale.abs().max()), "stein_shift": float(shift.abs().max())}


def rhat_max(z) -> float:
    """z: [chains, draws, d]."""
    r = frozen.potential_scale_reduction(z)
    return float("inf") if not bool(torch.isfinite(r).all()) else float(r.max())


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit; a number without a limit fails."""
    out = {n: {"value": numbers[n], "limit": limits.get(n)} for n in numbers}
    ok = all(v["limit"] is not None and math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
