"""The numbers that decide `correct`, each against its limit.

Training: each check step's loss, the first gradient's norm per leaf
(as the optimizer took it) and each leaf's change after the check
steps, as the gap between the program's and the reference's readings
over the larger of the reference's leaf norm and its median leaf's; the
leaves whose reference gradient is below a thousandth of the median
leaf's are left out.  The dead-prune's alive mask is exact.  Viewing:
the mean and the largest absolute gap of each kept frame to the
reference's frame, and for a stored model its loaded rows, exact.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3  # a leaf's gradient below this share of the median's


def _leaf_gaps(prog: dict, ref: dict, counted):
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in counted)


def counted_leaves(ref_grad_norms: dict):
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= NEGLIGIBLE * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    counted = counted_leaves(ref["grad_norms"])
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss,
            "grad_norm_gap": _leaf_gaps(prog["grad_norms"],
                                        ref["grad_norms"], counted),
            "change_norm_gap": _leaf_gaps(prog["change_norms"],
                                          ref["change_norms"], counted)}


def prune_mismatches(prune, threshold: float = 1.0 / 255.0) -> int:
    """Rows whose alive bit after the dead-prune differs from the
    published rule: alive before and sigmoid(opacity) >= 1/255."""
    before, opacity, after = prune
    want = before & ~(torch.sigmoid(opacity) < threshold)
    return int((want != after).sum())


def frame_numbers(frames: dict, refs: dict) -> dict:
    mean = max(float((frames[i] - refs[i]).abs().mean()) for i in refs)
    top = max(float((frames[i] - refs[i]).abs().max()) for i in refs)
    return {"frame_mean_gap": mean, "frame_max_gap": top}


def pool_mismatch(rows: dict, model: dict) -> float:
    """Largest absolute difference of the loaded rows to the reference's
    dequantised model (0 where the file was read as it means)."""
    pairs = [(rows["xyz"], model["xyz"]), (rows["scaling"], model["scaling"]),
             (rows["rotation"], model["rotation"]),
             (rows["opacity"], model["opacity"][:, 0]),
             (rows["sh"], model["sh"])]
    gap = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    if not torch.equal(rows["degrees"].long(), model["degrees"].long()):
        gap = float("inf")
    return gap


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or not a number, is a failure."""
    rows = []
    ok = True
    for name, value in numbers.items():
        lim = limits.get(name)
        good = (lim is not None and value == value and value <= lim)
        ok = ok and good
        rows.append((name, value, lim))
    return ok, rows
