"""Whether what the timed path produced is right, against the plain
reference.

Frames: the pixels each frame kept (seeded, ``program.FRAME_SAMPLE`` a
frame, every frame of the window) against the reference rendered at those
pixels; the number is the relative L1 gap, sum |program - reference| /
sum |reference|.

Fits: the reference follows the program's first three Adam steps from the
same start and target (its own Adam, written out). Compared: each step's
loss (relative gap, the worst of the three); the first gradient's norm as
Adam held it; the norm of the parameters' change after the three steps.
The two norms are taken per parameter (a leaf) and the worst leaf counts:
|norm_program - norm_reference| over the larger of the reference leaf's
norm and the median leaf's. A leaf whose reference gradient is under a
thousandth of the median leaf's moves by rounding alone and is left out.

Each number has its limit in ``limits/<cell>.json``; the run is correct
when every number is at or under its limit.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import Reference, adam


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.norm(x.detach().double()))


def leaf_gap(program: Dict[str, torch.Tensor],
             reference: Dict[str, torch.Tensor],
             ref_grads: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's |norm gap| over max(its reference norm, the median
    leaf's)."""
    gnorm = {k: _norm(g) for k, g in ref_grads.items()}
    gmed = statistics.median(gnorm.values())
    keep = [k for k in program if gnorm[k] >= 1e-3 * gmed]
    rnorm = {k: _norm(reference[k]) for k in keep}
    med = statistics.median(rnorm.values())
    return max(abs(_norm(program[k]) - rnorm[k]) / max(rnorm[k], med, 1e-30)
               for k in keep)


def fit_numbers(losses: List[float], first_grad: Dict, start: Dict,
                after: Dict, ref: Reference, target: torch.Tensor,
                lr: float, betas, eps) -> Dict[str, float]:
    """The three numbers of a fit against the reference's own steps."""
    ref_losses, ref_first, ref_after = adam(
        {k: v.to(ref.device, ref.dtype) for k, v in start.items()},
        lambda vals: ref.loss_and_grads(vals, target), len(losses), lr,
        betas, eps)
    dev = ref.device
    prog_change = {k: (after[k].to(dev).double() - start[k].to(dev).double())
                   for k in start}
    ref_change = {k: ref_after[k].double() - start[k].to(dev).double()
                  for k in start}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(losses, ref_losses)),
        "grad1_gap": leaf_gap({k: v.to(dev) for k, v in first_grad.items()},
                              ref_first, ref_first),
        "change3_gap": leaf_gap(prog_change, ref_change, ref_first),
    }


def frame_numbers(kept: List[np.ndarray], kept_ids: List[np.ndarray],
                  ref: Reference) -> Dict[str, float]:
    ids = np.concatenate(kept_ids)
    vals = np.concatenate(kept).astype(np.float64)
    uniq, inverse = np.unique(ids, return_inverse=True)
    pix = torch.as_tensor(uniq, device=ref.device)
    ref_vals = ref.image(pix, {}).double().cpu().numpy()[inverse]
    return {"frame_rel_l1": float(np.abs(vals - ref_vals).sum()
                                  / np.abs(ref_vals).sum())}


def verdict(numbers: Dict[str, float],
            limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {name: {value, limit}}); a number that is not finite
    fails."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return bool(ok), table
