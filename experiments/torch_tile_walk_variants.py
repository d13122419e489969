#!/usr/bin/env python3
"""Design variants of the tile-walk kernels K2 (reduced3dgs_torch/csrc/
tile_fwd.cu), K3 (csrc/tile_bwd.cu) and K4 (csrc/tile_trans.cu), timed on
one card.

    python3 experiments/torch_tile_walk_variants.py [--quick]
        [--match TEXT] [--parent DIR] [--turns N]

The sources' tunables are overridden with -D, one nvcc build per variant,
all started together, each with -Xptxas -v so that its registers, shared
memory and spills are printed:

  WALK_WARP_W         pixels per row of a 32-pixel block: 16 (16x2), 8
                      (8x4), 4 (4x8)
  WALK_EXP2           1: conic pre-scaled by log2 e + ex2.approx, 0: expf
  TILE_FWD_BATCH      K2's instances per shared-memory batch
  TILE_FWD_MIN_WARPS  K2's __launch_bounds__ as warps per SM (register cap;
                      TILE_BWD_MIN_WARPS: K3's)
  TILE_BWD_PPT        K3's pixels per thread: 1, 2, 4
  TILE_BWD_BATCH      K3's batch (its warp partials are 36 B an instance
                      and warp)
  TILE_TRANS_BATCH    K4's batch (TILE_TRANS_MIN_WARPS: its register cap)
  TILE_TRANS_UNROLL   K4's instances walked between two all-done votes

Earlier revisions of the sources also had several pixels per thread, a
second staging buffer, a persistent grid and an unrolled loop in K2,
nine separate shuffle trees and an unrolled loop in K3, and an f32
shuffle butterfly for K4's warp sums; they were timed with this script,
were slower, and are gone from the sources (PERF.md keeps their times).

Every variant is checked against the plain version (chip_smoke's
criteria), for exact zeros on unwalked slots (K3, K4) and for identical
bits from two launches, and timed (CUDA events, chip_smoke.time_ms) at the
1080p main-path inputs and at the 512p scene, in turns: the whole list is
walked --turns times.  --parent DIR also builds DIR/reduced3dgs_torch/
csrc/{tile_fwd,tile_bwd,tile_trans}.cu (an unpacked earlier commit), times
them in the same turns, says whether each default gives the parent's bits
(K2, K3, K4) and prints each library's SASS instruction count
(cuobjdump -sass; the listings are written beside the built libraries,
reduced3dgs_torch/_build/variants/*.sass).  The lane utilisation of each
warp footprint and the instances staged per batch size are printed
first.  Every line carries the
card's name and power limit.  --quick: the defaults and the parent only;
--match TEXT: the defaults and the variants whose -D list contains TEXT.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

K2_VARIANTS = [
    {},
    dict(WALK_WARP_W=16), dict(WALK_WARP_W=4),
    dict(WALK_EXP2=0),
    dict(TILE_FWD_BATCH=32), dict(TILE_FWD_BATCH=128),
    dict(TILE_FWD_MIN_WARPS=32), dict(TILE_FWD_MIN_WARPS=64),
    # the former footprint, exponent and batch: what the float4 staging
    # and the merged skip test give alone
    dict(WALK_WARP_W=16, WALK_EXP2=0, TILE_FWD_BATCH=128),
]
K4_VARIANTS = [
    {},
    dict(TILE_TRANS_UNROLL=1), dict(TILE_TRANS_UNROLL=2),
    dict(TILE_TRANS_BATCH=32), dict(TILE_TRANS_BATCH=64),
    dict(WALK_WARP_W=16), dict(WALK_WARP_W=4),
    dict(WALK_EXP2=0),
    dict(TILE_TRANS_MIN_WARPS=32), dict(TILE_TRANS_MIN_WARPS=64),
]
K3_VARIANTS = [
    {},
    dict(TILE_BWD_PPT=1, TILE_BWD_MIN_WARPS=48, TILE_BWD_BATCH=64),
    dict(TILE_BWD_PPT=1, TILE_BWD_BATCH=64),
    dict(TILE_BWD_PPT=4, TILE_BWD_MIN_WARPS=24),
    dict(TILE_BWD_PPT=4, TILE_BWD_MIN_WARPS=16),
    dict(TILE_BWD_PPT=4, TILE_BWD_MIN_WARPS=24, WALK_WARP_W=4),
    dict(WALK_WARP_W=4), dict(WALK_WARP_W=16),
    dict(TILE_BWD_MIN_WARPS=48), dict(TILE_BWD_MIN_WARPS=16),
    dict(TILE_BWD_BATCH=32), dict(TILE_BWD_BATCH=64),
    dict(WALK_EXP2=0),
    # one pixel per thread, the former footprint, exponent and batch
    dict(TILE_BWD_PPT=1, TILE_BWD_MIN_WARPS=48, WALK_WARP_W=16, WALK_EXP2=0,
         TILE_BWD_BATCH=128),
]


def tag(defs):
    return ",".join(f"{k}={v}" for k, v in defs.items()) or "default"


def build(source: Path, variants, cuda, prefix):
    """{tag: CDLL} of `source` per -D set; one nvcc each, all started
    together; ptxas' resource lines are printed."""
    out_dir = cuda.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, defs in enumerate(variants):
        out = out_dir / f"lib{prefix}-{i}.so"
        flags = [f"-D{k}={v}" for k, v in defs.items()]
        procs[tag(defs)] = (out, subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o",
             str(out), str(source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for t, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {prefix} {t}:\n{log}")
        used = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"nvcc {prefix} [{t}]: {' | '.join(used)}", flush=True)
        libs[t] = ctypes.CDLL(str(out))
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--match", default=None)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--turns", type=int, default=2)
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

    def chosen(variants):
        if args.quick:
            return variants[:1]
        return [v for v in variants
                if not v or args.match is None or args.match in tag(v)]

    fwd = build(_cuda.CSRC / "tile_fwd.cu", chosen(K2_VARIANTS), _cuda,
                "tile_fwd")
    bwd = build(_cuda.CSRC / "tile_bwd.cu", chosen(K3_VARIANTS), _cuda,
                "tile_bwd")
    trans = build(_cuda.CSRC / "tile_trans.cu", chosen(K4_VARIANTS), _cuda,
                  "tile_trans")
    # libraries of a parent whose walks take no tile base (before the
    # strips of the multi-device path): their launches have no base
    # argument, the sixth of the current ones
    baseless = set()
    if args.parent:
        csrc = Path(args.parent) / "reduced3dgs_torch" / "csrc"
        for libs, src in ((fwd, "tile_fwd"), (bwd, "tile_bwd"),
                          (trans, "tile_trans")):
            got = build(csrc / f"{src}.cu", [dict(PARENT=1)], _cuda,
                        f"parent_{src}")
            if b"int base" not in (csrc / f"{src}.cu").read_bytes():
                baseless |= {id(lib) for lib in got.values()}
            libs.update(got)
    for libs, sym, kern in ((fwd, "tile_fwd_launch", ttr.TILE_FWD),
                            (bwd, "tile_bwd_launch", ttr.TILE_BWD),
                            (trans, "tile_trans_launch", ttr.TILE_TRANS)):
        for lib in libs.values():
            fn = getattr(lib, sym)
            fn.restype = ctypes.c_int
            fn.argtypes = (kern.argtypes[:6] + kern.argtypes[7:]
                           if id(lib) in baseless else kern.argtypes)

    def base0(lib):
        """The tile base argument (0: the whole frame), if lib takes one."""
        return () if id(lib) in baseless else (0,)

    def run_fwd(lib, k2in, gx, w, h):
        feat, ranges, limit = k2in
        out = torch.empty((ranges.shape[1], ttr.PIX_ROWS, ttr.NPIX),
                          dtype=torch.float32, device=dev)
        err = lib.tile_fwd_launch(
            _cuda.ptr(feat), feat.stride(0), _cuda.ptr(ranges),
            ranges.shape[1], _cuda.ptr(limit), gx, *base0(lib), w, h,
            _cuda.ptr(out), _cuda.stream_of(feat))
        assert err == 0, err
        return out

    def run_bwd(lib, k2in, gx, w, h, g, packed):
        feat, ranges, limit = k2in
        rec = torch.zeros((feat.shape[1], ttr.GRAD_REC), dtype=torch.float32,
                          device=dev)
        err = lib.tile_bwd_launch(
            _cuda.ptr(feat), feat.stride(0), _cuda.ptr(ranges),
            ranges.shape[1], _cuda.ptr(limit), gx, *base0(lib), w, h,
            _cuda.ptr(g), _cuda.ptr(packed), _cuda.ptr(rec), ttr.GRAD_REC,
            _cuda.stream_of(feat))
        assert err == 0, err
        return rec.T[:ttr.TABLE_ROWS]

    def run_trans(lib, k2in, gx, w, h):
        feat, ranges, limit = k2in
        out = torch.zeros((2, feat.shape[1]), dtype=torch.float32,
                          device=dev)
        err = lib.tile_trans_launch(
            _cuda.ptr(feat), feat.stride(0), _cuda.ptr(ranges),
            ranges.shape[1], _cuda.ptr(limit), gx, *base0(lib), w, h,
            _cuda.ptr(out), out.stride(0), _cuda.stream_of(feat))
        assert err == 0, err
        return out

    scenes = {}
    for name, sc, budget in (("1080p", cs.MAIN, cs.BENCH_BUDGET),
                             ("512p", cs.K2_SCENE, cs.K2_SCENE["budget"])):
        w, h = sc["width"], sc["height"]
        _, _, k2in = cs.kernel_inputs(dev, w, h, sc["n"], sc["scales"],
                                      budget, args.seed)
        gx = -(-w // 16)
        want = ttr.tile_fwd_plain(*k2in, gx, w, h)
        g = cs.k3_cotangent(want, args.seed)
        dwant = ttr.tile_bwd_plain(*k2in, gx, w, h, g, want)
        walked = cs.walked_slots(k2in[1], k2in[2], k2in[0].shape[1])
        scenes[name] = dict(k2in=k2in, gx=gx, w=w, h=h, want=want, g=g,
                            dwant=dwant, unwalked=~walked,
                            twant=ttr.tile_trans_plain(*k2in, gx, w, h))
        inst = int((k2in[1][1] - k2in[1][0]).sum())
        for shape in ((16, 2), (8, 4), (4, 8)):
            for ppt in (1, 2, 4):
                _, pairs = ttr.tile_fwd_plain(
                    *k2in, gx, w, h, count_pairs=True, warp_shape=shape,
                    pixels_per_thread=ppt)
                print(f"{name}: instances {inst}, pairs walked "
                      f"{pairs['walked']}, blended {pairs['blended']}; "
                      f"{ppt} pixel(s) per thread on blocks of "
                      f"{shape[0]}x{shape[1]}: "
                      f"{cs.lane_text(pairs, 32 * ppt)}", flush=True)
        staged = {b: ttr.tile_fwd_plain(*k2in, gx, w, h, count_pairs=True,
                                        batch=b)[1]["staged"]
                  for b in (32, 64, 128)}
        print(f"{name}: instances staged per batch size {staged}", flush=True)

    # correctness of every variant at both scenes; the defaults' bits
    # against the parent's
    parent_bits = {}
    for t, lib in fwd.items():
        for name, sc in scenes.items():
            a = (sc["k2in"], sc["gx"], sc["w"], sc["h"])
            got, again = run_fwd(lib, *a), run_fwd(lib, *a)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (t, name, "K2 launches differ")
            err, share = cs.compare_k2(got, sc["want"])
            assert err <= 5e-3 and share >= 0.999, (t, name, err, share)
            parent_bits.setdefault(name, {})[t] = got
            print(f"K2 [{t}] {name}: max abs err {err:.3e}, share within "
                  f"1e-4 {share:.6f}, two launches bit-identical", flush=True)
    for t, lib in trans.items():
        for name, sc in scenes.items():
            a = (sc["k2in"], sc["gx"], sc["w"], sc["h"])
            got, again = run_trans(lib, *a), run_trans(lib, *a)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (t, name, "K4 launches differ")
            assert bool((got[:, sc["unwalked"]] == 0).all()), (t, name)
            c = cs.compare_k4(got, sc["twant"])
            assert c["err"] <= 1.01 and c["share"] >= 0.9999, (t, name, c)
            parent_bits.setdefault(("K4", name), {})[t] = got
            print(f"K4 [{t}] {name}: max abs err of the sums {c['err']:.3e}, "
                  f"share within 1e-3 {c['share']:.6f}, counts differ on "
                  f"{c['flips']} slots, two launches bit-identical",
                  flush=True)
    for t, lib in bwd.items():
        for name, sc in scenes.items():
            a = (sc["k2in"], sc["gx"], sc["w"], sc["h"], sc["g"], sc["want"])
            got, again = run_bwd(lib, *a), run_bwd(lib, *a)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (t, name, "K3 launches differ")
            assert bool((got[:, sc["unwalked"]] == 0).all()), (t, name)
            err, rel, share = cs.compare_k3(got, sc["dwant"])
            assert rel <= 5e-3 and share >= 0.999, (t, name, rel, share)
            parent_bits.setdefault(("K3", name), {})[t] = got
            print(f"K3 [{t}] {name}: largest error / row max {rel:.3e}, "
                  f"share within 1e-4 of the row max {share:.6f}, two "
                  "launches bit-identical", flush=True)

    for key, outs in parent_bits.items():
        if "PARENT=1" in outs:
            kname, name = key if isinstance(key, tuple) else ("K2", key)
            same = torch.equal(outs["default"], outs["PARENT=1"])
            print(f"{kname} {name}: the default gives the parent's bits: "
                  f"{same}", flush=True)
    if args.parent:
        cuda_bin = os.path.dirname(_cuda._nvcc())
        sass_dir = _cuda.BUILD_DIR / "variants"
        for kname, libs in (("K2", fwd), ("K3", bwd), ("K4", trans)):
            counts = {}
            for t in ("default", "PARENT=1"):
                listing = subprocess.run(
                    [str(Path(cuda_bin) / "cuobjdump"), "-sass",
                     libs[t]._name], capture_output=True, text=True).stdout
                (sass_dir / f"{kname}_{t.replace('=', '')}.sass").write_text(
                    listing)
                counts[t] = sum(1 for ln in listing.splitlines()
                                if ln.strip().startswith("/*")
                                and "*/" in ln and ";" in ln)
            print(f"{kname}: SASS instructions, default {counts['default']}"
                  f", parent {counts['PARENT=1']}", flush=True)

    # times, in turns
    for turn in range(args.turns):
        for kname, libs, run in (("K2", fwd, run_fwd), ("K3", bwd, run_bwd),
                                 ("K4", trans, run_trans)):
            for t, lib in libs.items():
                line = [f"{kname} [{t}] turn {turn}:"]
                for name, sc in scenes.items():
                    a = (sc["k2in"], sc["gx"], sc["w"], sc["h"])
                    if kname == "K3":
                        a += (sc["g"], sc["want"])
                    ms = cs.time_ms(lambda: run(lib, *a), 20)
                    line.append(f"{name} {ms:.4f} ms,")
                print(" ".join(line) + f" {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
