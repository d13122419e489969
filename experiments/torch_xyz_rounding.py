#!/usr/bin/env python
"""How a stored model's PSNR depends on the precision of its positions
(PyTorch port): xyz as stored (f32), rounded through float16 (the
half-float file's), through bfloat16 (the input precision of a matrix
product at a TPU's default precision), and through float16 then
bfloat16.  Also the share of alive rows whose bfloat16 position moves
when float16 rounding comes first.

    python3 experiments/torch_xyz_rounding.py --root DIR \
        [--models model_full model_vanilla] [--iterations 10000] \
        [--device cpu]

DIR is a ``python -m reduced3dgs_torch.compression_eval`` root; every
score is compression_eval.mean_psnr over its test views.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--models", nargs="+",
                    default=["model_full", "model_vanilla"])
    ap.add_argument("--iterations", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from reduced3dgs_torch.compression_eval import mean_psnr, stored_model
    from reduced3dgs_torch.device import resolve

    device = resolve(args.device)

    def f16(t):
        return t.to(torch.float16).to(torch.float32)

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    out = {}
    for m in args.models:
        scene, pool = stored_model(args.root, m, args.iterations, device)
        cams = scene.get_test_cameras()
        x = pool.params.xyz

        def score(xyz):
            return mean_psnr(pool.replace(params=pool.params._replace(
                xyz=xyz)), cams, device)

        moved = (bf16(f16(x)) != bf16(x)).any(1)[pool.alive]
        out[m] = {"f32": score(x), "f16": score(f16(x)),
                  "bf16": score(bf16(x)), "f16_then_bf16": score(bf16(f16(x))),
                  "bf16_moved_by_f16": float(moved.float().mean())}
        print(m, json.dumps(out[m]), flush=True)
    return out


if __name__ == "__main__":
    main()
