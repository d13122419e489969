#!/usr/bin/env python3
"""Design variants of K5 / K6 (reduced3dgs_torch/csrc/seg_reduce.cu) and
of K3's record width, timed on one card.

    python3 experiments/torch_seg_reduce_variants.py [--quick]

The source's tunables (SEG_LANES lanes per segment, SEG_GROUP_MAX and
SEG_WARP_MAX the tier limits, SEG_UNROLL records in flight per lane) are
overridden with -D, one nvcc build per variant, all started together, and
every variant is
  * checked against the float64 segment sums and for identical bits from
    two launches,
  * timed (CUDA events, chip_smoke.time_ms) in both modes at the 1080p
    main-path shapes (K3's real output for the bench scene's view) and in
    f32 mode on chip_smoke's skewed layout.
K3 (csrc/tile_bwd.cu) is timed writing records of 9, 12 and 16 floats, and
the default K5 / K6 reading 12 and 16.  Every line carries the card's name
and power limit.  --quick: only the default variant and the record widths.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEFAULT = dict(SEG_LANES=4, SEG_GROUP_MAX=32, SEG_WARP_MAX=256, SEG_UNROLL=4)
VARIANTS = [
    {},
    dict(SEG_LANES=1), dict(SEG_LANES=2),
    dict(SEG_UNROLL=1), dict(SEG_UNROLL=2), dict(SEG_UNROLL=8),
    dict(SEG_GROUP_MAX=8), dict(SEG_GROUP_MAX=16), dict(SEG_GROUP_MAX=64),
    dict(SEG_WARP_MAX=64), dict(SEG_WARP_MAX=1024), dict(SEG_WARP_MAX=4096),
    dict(SEG_LANES=1, SEG_WARP_MAX=1024),
    # no tiers: every segment by its own group, whatever its length
    dict(SEG_GROUP_MAX=1 << 30, SEG_WARP_MAX=1 << 30),
    dict(SEG_LANES=1, SEG_GROUP_MAX=1 << 30, SEG_WARP_MAX=1 << 30),
    # no block tier
    dict(SEG_WARP_MAX=1 << 30),
]


PTXAS_V = ("4-32-256-4", "1-32-256-4", "2-32-256-4", "4-32-256-8")  # resources


def tag(defs):
    d = dict(DEFAULT, **defs)
    return "-".join(str(d[k]) for k in DEFAULT)


def build_variants(variants, cuda):
    """{tag: CDLL}; one nvcc per variant, all started together."""
    out_dir = cuda.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = cuda.CSRC / "seg_reduce.cu"
    procs = {}
    for defs in variants:
        t = tag(defs)
        out = out_dir / f"libseg_reduce-{t}.so"
        flags = [f"-D{k}={v}" for k, v in dict(DEFAULT, **defs).items()]
        extra = ["-Xptxas", "-v"] if t in PTXAS_V else []
        procs[t] = (out, subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, *flags, *extra, "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for t, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {t}:\n{log}")
        if log.strip():
            print(f"nvcc, variant {t}:\n{log.strip()}", flush=True)
        libs[t] = ctypes.CDLL(str(out))
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from reduced3dgs_torch.ops import _cuda
    from reduced3dgs_torch.ops import tile_render as ttr

    dev = torch.device("cuda")
    smi = cs.smi_line()
    print(smi, flush=True)
    _cuda.build(_cuda.SOURCES)

    # K3 at the main path's shapes, per record width
    m = cs.MAIN
    _, binning, (src, ranges, limit) = cs.kernel_inputs(
        dev, m["width"], m["height"], m["n"], m["scales"], cs.BENCH_BUDGET,
        args.seed)
    gx = -(-m["width"] // 16)
    packed_out = ttr._tile_fwd_cuda(src, ranges, limit, gx, m["width"],
                                    m["height"])
    g = cs.k3_cotangent(packed_out, args.seed)
    k3in = (src, ranges, limit, gx, m["width"], m["height"], g, packed_out)
    default_rec = ttr.GRAD_REC
    rows_by_rec = {}
    for turn in range(2):  # in turns: widths interleaved, twice
        for rec in (9, 12, 16):
            ttr.GRAD_REC = rec
            ms = cs.time_ms(lambda: ttr._tile_bwd_cuda(*k3in), 20)
            print(f"K3 writing records of {rec} floats (turn {turn}): "
                  f"{ms:.4f} ms; {smi}", flush=True)
            if rec >= 12:
                rows_by_rec[rec] = ttr._tile_bwd_cuda(*k3in)
    ttr.GRAD_REC = default_rec
    torch.cuda.synchronize()
    assert torch.equal(rows_by_rec[12], rows_by_rec[16])

    order = ttr.segment_order(binning)
    bounds = binning.seg_bounds.contiguous()
    sk_b, sk_rows = cs.segments_binning(dev, cs.SKEWED["p"],
                                        cs.skewed_lens(**cs.SKEWED))
    sk = cs.seg_inputs(sk_b, sk_rows)
    cases = {"main": (rows_by_rec[default_rec], order, bounds), "skewed": sk}
    refs = {(name, packed): cs.seg_reference(*inp, packed)
            for name, inp in cases.items() for packed in (False, True)}
    lens = bounds[1:] - bounds[:-1]
    print(f"main path: P {bounds.shape[0] - 1}, instances "
          f"{int(bounds[-1])}, B_pad {order.shape[0]}, longest segment "
          f"{int(lens.max())}, segments over 32: {int((lens > 32).sum())}; "
          f"skewed: P {sk[2].shape[0] - 1}, instances {int(sk[2][-1])}",
          flush=True)

    for rec in (12, 16):
        for packed in (False, True):
            rows = rows_by_rec[rec]
            ms = cs.time_ms(lambda: ttr._seg_reduce_cuda(
                rows, order, bounds, packed), 50)
            print(f"default kernel, records of {rec} floats, "
                  f"{'bf16x2' if packed else 'f32'}: {ms:.4f} ms; {smi}",
                  flush=True)

    variants = VARIANTS[:1] if args.quick else VARIANTS
    libs = build_variants(variants, _cuda)

    def run(lib, inputs, packed):
        rows, order, bounds = inputs
        fn = getattr(lib, "seg_reduce_packed_launch" if packed
                     else "seg_reduce_f32_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = ttr._SEG_ARGS
        num_p = bounds.shape[0] - 1
        out = torch.empty((9, num_p), dtype=torch.float32, device=dev)
        err = fn(_cuda.ptr(rows), rows.stride(1), _cuda.ptr(order),
                 _cuda.ptr(bounds), num_p, _cuda.ptr(out), out.stride(0),
                 _cuda.stream_of(rows))
        assert err == 0, err
        return out

    for defs in variants:
        t = tag(defs)
        line = [f"variant lanes-groupmax-warpmax-unroll {t}:"]
        for name, packed in (("main", False), ("main", True),
                             ("skewed", False)):
            inp = cases[name]
            got = run(libs[t], inp, packed)
            again = run(libs[t], inp, packed)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (t, name, "launches differ")
            cs.check_seg(got, *refs[name, packed], f"{t} {name}")
            reps = 50 if name == "main" else 10
            ms = cs.time_ms(lambda: run(libs[t], inp, packed), reps)
            line.append(f"{name} {'bf16x2' if packed else 'f32'} "
                        f"{ms:.4f} ms,")
        print(" ".join(line) + f" {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
