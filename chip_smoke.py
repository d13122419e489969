#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (reduced3dgs_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero
before the final line:

 1. card name / power limit (nvidia-smi) and the nvcc build of every
    kernel source of the render path, all built in parallel;
 2. K1 (csrc/expand.cu) against its plain version, bit-exact, on the
    binning-test cases plus budget truncation and no marks;
 3. K2 (csrc/tile_fwd.cu) against its plain version on the 512x512,
    2^17-primitive scene (every pixel within 5e-3, >= 99.9 % within 1e-4),
    and the whole render (kernels) against the masked oracle on a small
    scene;
 4. the main path at full size: a 1920x1080 model of 2^19 SH-degree-3
    primitives made from --seed, written as point_cloud.ply and
    point_cloud_quantised_half.ply (256-entry quantile codebooks), loaded
    through the port's Scene / ply_io, and rendered over a ring of 8 views
    through reduced3dgs_torch.render (budget ladder, FPS by CUDA events);
    the kernels' launch counters are zeroed just before and read just
    after, and must have risen;
 5. per-kernel times (CUDA events) at the main path's shapes beside the
    plain versions, the bound, and a PyTorch yardstick; one JSON line;
 6. where a frame's time goes (baseline model, the ring, the settled
    budget): stage times by CUDA events through renderer.render's marks,
    then one pass under torch.profiler whose kernel time is set against
    the CUDA-event span of that same pass (the device's idle share).

The last line is {"ok": true, "device": {...}}.  Without a card, or
without the rest of the repository beside it, it exits non-zero first.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# full-size main path: the headline geometry of bench.py's 1080p config
MAIN = dict(width=1920, height=1080, n=1 << 19, scales=(0.00432, 0.0189))
# the K2 check scene: bench.py's 512p config
K2_SCENE = dict(width=512, height=512, n=1 << 17, scales=(0.008, 0.040),
                budget=3 << 18)
RING_VIEWS = 8
RING_RADIUS = 3.6

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 outside
# the tensor cores
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations of csrc/tile_fwd.cu's inner loop per (pixel, instance)
# pair, counted in its SASS (cuobjdump -sass of the built library, nvcc
# 12.8, sm_90a), an FFMA as 2 (as the peak counts it) and an FADD, FMUL,
# FSETP or FMNMX as 1.  Every walked pair: dx, dy 2 FADD; power 5 FMUL and
# 2 FFMA (11); the power test 1; min(power, 0) 1; expf 4 FFMA, 1 FADD and
# 1 FMUL (10) plus one MUFU.EX2 on the special-function units, which is
# not counted (at 16 per SM and clock it is not the tighter limit);
# op * e 1; min(0.99, .) 1; the alpha test 1: 26.  A blended pair adds
# 1 - alpha, T * (1 - alpha), the T test, alpha * T and three colour
# FFMAs: 10.  The pair that stops a pixel adds the first three: 3.
K2_OPS_WALKED = 26
K2_OPS_BLEND = 10
K2_OPS_STOP = 3
K1_OPS_PER_STEP = 4  # load, compare, select, shift per search step
PROFILE_TOP = 12  # kernels listed by phase 6


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


class Codebook(NamedTuple):
    ids: np.ndarray  # (rows * k,) uint8
    centers: np.ndarray  # (256, 1) f32


def quantile_codebooks(arrs, num_clusters=256):
    """The 20 codebooks save_gaussian_ply stores, from numpy quantiles of
    each attribute's values (nearest center per value)."""
    cols = {
        "features_dc": arrs["features_dc"][:, 0, :],
        "opacity": arrs["opacity"],
        "scaling": arrs["scaling"],
        "rotation_re": arrs["rotation"][:, :1],
        "rotation_im": arrs["rotation"][:, 1:],
    }
    for i in range(15):
        cols[f"features_rest_{i}"] = arrs["features_rest"][:, i, :]
    books = {}
    for k, v in cols.items():
        flat = np.ascontiguousarray(v, np.float32).reshape(-1)
        centers = np.quantile(
            flat, (np.arange(num_clusters) + 0.5) / num_clusters)
        centers = np.unique(centers.astype(np.float32))
        centers = np.pad(centers, (0, num_clusters - centers.size), "edge")
        mids = (centers[1:] + centers[:-1]) * 0.5
        ids = np.searchsorted(mids, flat).astype(np.uint8)
        books[k] = Codebook(ids=ids, centers=centers.reshape(-1, 1))
    return books


def make_arrays(n, scales, seed):
    """A random model as load_gaussian_ply arrays (bench.py's scene)."""
    rng = np.random.default_rng(seed)
    smin, smax = scales
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    feats[:, 1:] = rng.normal(0, 0.2, (n, 15, 3))
    return {
        "xyz": rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
        "features_dc": feats[:, :1].copy(),
        "features_rest": feats[:, 1:].copy(),
        "scaling": np.log(rng.uniform(smin, smax, (n, 3))).astype(np.float32),
        "rotation": rng.normal(0, 1, (n, 4)).astype(np.float32),
        "opacity": rng.uniform(-2, 3, (n, 1)).astype(np.float32),
        "degrees": np.full(n, 3, np.int32),
    }


def ring_cameras(width, height, n_views=RING_VIEWS, radius=RING_RADIUS):
    from reduced3dgs_torch.cameras import Camera

    cams = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        cams.append(Camera.look_at(
            eye=(radius * math.sin(a), 0.0, -radius * math.cos(a)),
            target=(0, 0, 0), width=width, height=height, uid=i + 1,
            image_name=f"view_{i:03d}"))
    return cams


def _rotmat2qvec(R):
    """Rotation matrix -> (w, x, y, z) quaternion (inverse of qvec2rotmat)."""
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def write_colmap_text(root, cams):
    """A COLMAP text project (no images) holding `cams`."""
    from reduced3dgs_torch.ops.transforms import fov2focal

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        for c in cams:
            f.write(f"{c.uid} PINHOLE {c.width} {c.height} "
                    f"{fov2focal(c.fov_x, c.width)!r} "
                    f"{fov2focal(c.fov_y, c.height)!r} "
                    f"{c.width / 2} {c.height / 2}\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        for c in cams:
            q = _rotmat2qvec(np.asarray(c.R).T)  # world->camera rotation
            vals = " ".join(repr(float(v)) for v in (*q, *c.T))
            f.write(f"{c.uid} {vals} {c.uid} {c.image_name}.png\n")
            f.write("0.0 0.0 -1\n")
    pts = np.random.default_rng(0).uniform(-1, 1, (16, 3))
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i, p in enumerate(pts):
            f.write(f"{i + 1} {p[0]} {p[1]} {p[2]} 128 128 128 0.5\n")


def write_model(root, arrs, cams, iteration=1):
    """source/ (COLMAP text) + model/point_cloud/iteration_N/{plain,
    quantised_half} PLYs; returns the port's ModelParams for it."""
    from reduced3dgs_torch.config import ModelParams
    from reduced3dgs_torch.models.gaussians import (
        padded_leaves, pool_from_numpy,
    )
    from reduced3dgs_torch.models.ply_io import save_gaussian_ply

    src = os.path.join(root, "source")
    model = os.path.join(root, "model")
    write_colmap_text(src, cams)
    pool = pool_from_numpy(
        padded_leaves(arrs, capacity=arrs["xyz"].shape[0]), "cpu")
    pc = os.path.join(model, "point_cloud", f"iteration_{iteration}")
    save_gaussian_ply(os.path.join(pc, "point_cloud.ply"), pool)
    save_gaussian_ply(os.path.join(pc, "point_cloud_quantised_half.ply"),
                      pool, quantile_codebooks(arrs), quantised=True,
                      half_float=True)
    return ModelParams(source_path=src, model_path=model, resolution=1)


# ---------------------------------------------------------------------------
# phase helpers (device-agnostic, so the CPU tests can rehearse them)
# ---------------------------------------------------------------------------

def expand_cases():
    """(mark_pos, rank1, rectpack, budget) cases for K1."""
    cases = []
    for p, budget, kind in [(700, 8192 + 1024, "plain"),
                            (2200, 32 * 1024, "plain"),
                            (2200, 16 * 1024, "truncate"),
                            (300, 2048, "empty")]:
        rng = np.random.default_rng(11)
        counts = rng.poisson(11, p).astype(np.int64)
        counts[:80] = 0
        counts[rng.integers(0, p, 60)] = 0
        if kind == "empty":
            counts[:] = 0
        offsets = np.cumsum(counts)
        starts = (offsets - counts).astype(np.int32)
        mark_pos = np.where(counts > 0, starts, budget).astype(np.int32)
        check((offsets[-1] > budget) == (kind == "truncate"),
              f"expand case {kind} is not what it claims")
        cases.append((kind, mark_pos, np.arange(1, p + 1, dtype=np.int32),
                      rng.integers(0, 1 << 30, p).astype(np.int32), budget))
    return cases


def bench_scene(n, scales, seed):
    """(xyz, features, scales, rotations, opacity, degrees) numpy arrays."""
    a = make_arrays(n, scales, seed)
    return (a["xyz"], np.concatenate([a["features_dc"], a["features_rest"]],
                                     axis=1),
            a["scaling"], a["rotation"], a["opacity"][:, 0], a["degrees"])


def kernel_inputs(device, width, height, n, scales, budget, seed=0,
                  eye=(0.0, 0.0, -RING_RADIUS)):
    """Run preprocess + binning of a bench-style scene on `device` and
    return (prep, binning, K2's (feat, ranges, limit))."""
    import torch

    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.ops import binning, preprocess, tile_render

    arrs = [torch.as_tensor(a, device=device)
            for a in bench_scene(n, scales, seed)]
    cam = Camera.look_at(eye=eye, target=(0, 0, 0), width=width,
                         height=height)
    with torch.no_grad():
        prep = preprocess.preprocess(
            arrs[0], arrs[2], arrs[3], arrs[4], arrs[1], arrs[5],
            cam.params(device))
        b = binning.bin_gaussians(prep, width, height, budget)
        feat, b_pad = tile_render._pack_features(b)
    limit = torch.clamp(b.total_padded, max=b_pad).to(torch.int32)
    return prep, b, (feat, b.tile_ranges.contiguous(), limit)


def k2_ops(pairs):
    """K2's f32 operations for tile_fwd_plain's pair counts."""
    return (K2_OPS_WALKED * pairs["walked"] + K2_OPS_BLEND * pairs["blended"]
            + K2_OPS_STOP * pairs["stopped"])


def compare_k2(out, ref):
    """Max abs error and the share of values within 1e-4 (colour and T
    rows of every pixel)."""
    d = (out[:, 0:4, :] - ref[:, 0:4, :]).abs()
    return float(d.max()), float((d <= 1e-4).double().mean())


def main_path(device, root, width, height, n, scales, seed, n_views):
    """Write, load and render the model through the port's entry points.
    Returns one dict per variant."""
    import torch

    from reduced3dgs_torch.render import (
        PoolView, measure_fps, next_budget, render_view,
    )
    from reduced3dgs_torch.scene import Scene

    cams = ring_cameras(width, height, n_views)
    t0 = time.perf_counter()
    args = write_model(root, make_arrays(n, scales, seed), cams)
    t_write = time.perf_counter() - t0
    scene = Scene(args, load_iteration=-1, shuffle=False, lazy_images=True)
    views = scene.get_train_cameras()
    check(len(views) == n_views and (views[0].width, views[0].height)
          == (width, height), "scene cameras do not match the ring")
    bg = torch.zeros(3, device=device)
    results = {}
    for variant, kw in (("baseline", {}),
                        ("quantised_half", dict(quantised=True,
                                                half_float=True))):
        t0 = time.perf_counter()
        pv = PoolView(scene.load_model(device=device, **kw))
        t_load = time.perf_counter() - t0
        check(int(pv.alive.sum()) == n, f"{variant}: loaded pool size")
        imgs, budgets, nrs = [], [], []
        budget = next_budget(1 << 15, 1)
        for cam in views:
            out, budget = render_view(pv, cam, bg, budget)
            nr = int(out.num_rendered)
            check(out.color.shape == (height, width, 3), "image shape")
            check(bool(torch.isfinite(out.color).all())
                  and bool(torch.isfinite(out.final_t).all()),
                  f"{variant}: non-finite image")
            check(nr <= budget, f"{variant}: num_rendered {nr} > {budget}")
            cover = float((out.final_t < 0.5).float().mean())
            check(cover > 0.2, f"{variant}: coverage {cover:.3f} too low")
            imgs.append(out.color.float().cpu())
            budgets.append(budget)
            nrs.append(nr)
        fps = measure_fps(pv, views, bg)
        results[variant] = dict(
            fps=fps["fps"], view_ms=fps["view_ms"], fps_budget=fps["budget"],
            num_rendered=nrs, budgets=budgets, load_s=t_load,
            images=torch.stack(imgs), pool=pv)
    results["write_s"] = t_write
    results["views"] = views
    return results


def psnr(a, b):
    mse = float(((a.clamp(0, 1) - b.clamp(0, 1)) ** 2).mean())
    return 10 * math.log10(1.0 / max(mse, 1e-12))


# ---------------------------------------------------------------------------
# card-only parts
# ---------------------------------------------------------------------------

def time_ms(fn, reps):
    """Mean milliseconds per call by CUDA events around `reps` calls,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def bound(nbytes, ops):
    """(bound ms, "bytes" | "operations", bytes ms, operations ms)."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from reduced3dgs_torch.ops import _cuda
    from reduced3dgs_torch.ops import binning as tbin
    from reduced3dgs_torch.ops import tile_render as ttr

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(smi, flush=True)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {kind}", flush=True)
    t0 = time.perf_counter()
    _cuda.build(_cuda.SOURCES)
    print(f"phase 1: built {', '.join(_cuda.SOURCES)} with nvcc "
          f"{' '.join(_cuda.NVCC_FLAGS)} in {time.perf_counter() - t0:.3f} s",
          flush=True)

    # --- phase 2: K1 bit-exact ----------------------------------------
    for name, mark_pos, rank1, rect, budget in expand_cases():
        c = tbin.compact_marks(*(torch.as_tensor(a, device=dev)
                                 for a in (mark_pos, rank1, rect)), budget)
        got = tbin._expand_marks_cuda(*c, budget)
        want = tbin.expand_marks_plain(*c, budget)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 {name}: kernel != plain")
        print(f"phase 2: K1 {name} P={mark_pos.size} budget={budget}: "
              "bit-exact", flush=True)

    # --- phase 3: K2 on the 512p scene; whole render vs the oracle ------
    s = K2_SCENE
    _, b512, k2in = kernel_inputs(dev, s["width"], s["height"], s["n"],
                                  s["scales"], s["budget"], args.seed)
    gx = -(-s["width"] // 16)
    got = ttr._tile_fwd_cuda(*k2in, gx, s["width"], s["height"])
    want = ttr.tile_fwd_plain(*k2in, gx, s["width"], s["height"])
    torch.cuda.synchronize()
    err, share = compare_k2(got, want)
    print(f"phase 3: K2 512p num_rendered={int(b512.num_rendered)}: max abs "
          f"err {err:.3e}, share within 1e-4 {share:.6f}", flush=True)
    check(err <= 5e-3 and share >= 0.999, "K2 512p: kernel != plain")
    small = _small_render_check(dev)
    print(f"phase 3: small scene, kernels vs masked oracle on the card: "
          f"max abs err {small:.3e}", flush=True)

    # --- phase 4: the main path at full size ----------------------------
    root = os.path.join(REPO, ".chip_smoke_run")
    shutil.rmtree(root, ignore_errors=True)
    tbin.EXPAND.launches = 0
    ttr.TILE_FWD.launches = 0
    res = main_path(dev, root, MAIN["width"], MAIN["height"], MAIN["n"],
                    MAIN["scales"], args.seed, RING_VIEWS)
    launches = {"expand": tbin.EXPAND.launches,
                "tile_fwd": ttr.TILE_FWD.launches}
    check(all(v > 0 for v in launches.values()),
          f"main path bypassed a kernel: {launches}")
    for variant in ("baseline", "quantised_half"):
        r = res[variant]
        print(f"phase 4: {variant}: {r['fps']:.3f} FPS over {RING_VIEWS} "
              f"views at {MAIN['width']}x{MAIN['height']} (budget "
              f"{r['fps_budget']}, num_rendered {min(r['num_rendered'])}.."
              f"{max(r['num_rendered'])}, view ms "
              f"{', '.join(f'{v:.3f}' for v in r['view_ms'])}; load "
              f"{r['load_s']:.3f} s)", flush=True)
    q_psnr = psnr(res["baseline"]["images"], res["quantised_half"]["images"])
    print(f"phase 4: model write {res['write_s']:.3f} s; quantised_half vs "
          f"baseline PSNR {q_psnr:.3f} dB; launches {launches}", flush=True)
    check(q_psnr > 15.0, "quantised_half render diverges from baseline")

    # --- phase 5: kernel times at the main path's shapes ----------------
    budget = res["baseline"]["fps_budget"]
    prep, _, k2in = kernel_inputs(dev, MAIN["width"], MAIN["height"],
                                  MAIN["n"], MAIN["scales"], budget,
                                  args.seed)
    shutil.rmtree(root, ignore_errors=True)
    kernels = [_report_k1(prep, MAIN["width"], MAIN["height"], budget,
                          launches["expand"], tbin),
               _report_k2(k2in, MAIN["width"], MAIN["height"],
                          launches["tile_fwd"], ttr)]
    del prep, k2in

    # --- phase 6: where a frame's time goes -----------------------------
    _profile_frames(res["baseline"]["pool"], res["views"], budget, smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _small_render_check(dev):
    """The whole render through the kernels against the masked oracle on
    a small scene (56x40, 300 primitives): atol 2e-5 / rtol 1e-4."""
    import torch

    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.renderer import render

    a = [torch.as_tensor(x, device=dev)
         for x in bench_scene(300, (0.02, 0.12), 1)]
    cp = Camera.look_at(eye=(0, 0, -3.2), target=(0, 0, 0), width=56,
                        height=40).params(dev)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    outs = [render(*a, cp, bg, width=56, height=40, instance_budget=4096,
                   backend=be) for be in ("tile", "ref")]
    check(int(outs[0].num_rendered) > 300, "small scene too sparse")
    err = float((outs[0].color - outs[1].color).abs().max())
    check(torch.allclose(outs[0].color, outs[1].color, atol=2e-5, rtol=1e-4)
          and torch.allclose(outs[0].final_t, outs[1].final_t, atol=2e-5,
                             rtol=1e-4), f"kernels vs oracle: {err:.3e}")
    return err


def _report_k1(prep, width, height, budget, launches, tbin):
    """K1 at the main path's shapes: its inputs are captured from one
    bin_gaussians call of the main-path view (not counted)."""
    import torch

    captured = {}
    orig = tbin.expand_marks

    def spy(*a):
        captured["args"] = a
        return orig(*a)

    tbin.expand_marks = spy
    try:
        tbin.bin_gaussians(prep, width, height, budget)
    finally:
        tbin.expand_marks = orig
    pos, rank1, rectw, bud = captured["args"]
    got = tbin._expand_marks_cuda(pos, rank1, rectw, bud)
    want = tbin.expand_marks_plain(pos, rank1, rectw, bud)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K1 main-path shapes: kernel != plain")
    slots = torch.arange(bud, dtype=torch.int32, device=pos.device)
    ms = time_ms(lambda: tbin._expand_marks_cuda(pos, rank1, rectw, bud), 50)
    plain_ms = time_ms(lambda: tbin.expand_marks_plain(pos, rank1, rectw,
                                                       bud), 5)
    lib_ms = time_ms(lambda: torch.searchsorted(pos, slots, right=True), 20)
    n = pos.numel()
    steps = math.ceil(math.log2(n + 1))
    bms, by, b_ms, o_ms = bound(3 * 4 * n + 3 * 4 * bud,
                                bud * steps * K1_OPS_PER_STEP)
    print(f"phase 5: K1 P={n} budget={bud}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.searchsorted {lib_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}; bytes {b_ms:.4f}, operations {o_ms:.4f}), "
          f"roofline share {bms / ms * 100:.1f} %", flush=True)
    return {"name": "expand", "route": "cuda",
            "source": "reduced3dgs_torch/csrc/expand.cu",
            "replaces": "reduced3dgs_tpu/ops/binning.py:164",
            "launches": launches, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def _report_k2(k2in, w, h, launches, ttr):
    """K2 at the main path's shapes (the main-path view's binning)."""
    import torch

    gx = -(-w // 16)
    got = ttr._tile_fwd_cuda(*k2in, gx, w, h)
    want, pairs = ttr.tile_fwd_plain(*k2in, gx, w, h, count_pairs=True)
    torch.cuda.synchronize()
    err, share = compare_k2(got, want)
    check(err <= 5e-3 and share >= 0.999,
          f"K2 main-path shapes: kernel != plain ({err:.3e}, {share:.6f})")
    ms = time_ms(lambda: ttr._tile_fwd_cuda(*k2in, gx, w, h), 20)
    plain_ms = time_ms(lambda: ttr.tile_fwd_plain(*k2in, gx, w, h), 2)
    ranges = k2in[1]
    inst = int((ranges[1] - ranges[0]).sum())
    num_tiles = ranges.shape[1]
    nbytes = 4 * ttr.TABLE_ROWS * inst + 8 * num_tiles \
        + 4 * ttr.PIX_ROWS * ttr.NPIX * num_tiles
    bms, by, b_ms, o_ms = bound(nbytes, k2_ops(pairs))
    print(f"phase 5: K2 tiles={num_tiles} instances={inst} pairs walked "
          f"{pairs['walked']}, blended {pairs['blended']}, stopped "
          f"{pairs['stopped']}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}; bytes {b_ms:.4f}, operations {o_ms:.4f}), "
          f"roofline share {bms / ms * 100:.1f} %; max abs err {err:.3e}, "
          f"share within 1e-4 {share:.6f}", flush=True)
    return {"name": "tile_fwd", "route": "cuda",
            "source": "reduced3dgs_torch/csrc/tile_fwd.cu",
            "replaces": "reduced3dgs_tpu/ops/tile_render.py:324",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}



def _profile_frames(pv, views, budget, smi):
    """Phase 6 on the baseline model over the ring at the settled budget.
    Stage times come from renderer.render's marks with the profiler off;
    the idle share comes from one pass under torch.profiler: its kernel
    time against the CUDA-event span of that same pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from reduced3dgs_torch.render import render_once
    from reduced3dgs_torch.renderer import STAGES

    bg = torch.zeros(3, device=pv.device)
    cps = [c.params(pv.device) for c in views]
    nv = len(cps)
    for cp in cps:  # warm-up at the budget
        render_once(pv, cp, bg, budget)
    torch.cuda.synchronize()
    stage = [0.0] * len(STAGES)
    host = 0.0
    for cp in cps:
        marks = []
        t0 = time.perf_counter()
        render_once(pv, cp, bg, budget, marks=marks)
        marks[-1].synchronize()
        host += time.perf_counter() - t0
        for i in range(len(STAGES)):
            stage[i] += marks[i].elapsed_time(marks[i + 1])
    print(f"phase 6: baseline {nv} views, budget {budget}, profiler off: "
          "stage ms per view (CUDA events) "
          f"{', '.join(f'{n} {v / nv:.3f}' for n, v in zip(STAGES, stage))}"
          f"; frame {sum(stage) / nv:.3f} ms on the device, "
          f"{host / nv * 1e3:.3f} ms host wall; {smi}", flush=True)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for cp in cps:
            render_once(pv, cp, bg, budget)
        end.record()
        end.synchronize()
    span = start.elapsed_time(end) / nv
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    check(rows, "profiler saw no kernel on the card")
    busy = sum(r[0] for r in rows) / 1e3 / nv
    launches = sum(r[1] for r in rows) / nv
    print(f"phase 6: profiled pass: {launches:.1f} kernel launches and "
          f"{busy:.3f} ms of kernel time per frame over a CUDA-event span "
          f"of {span:.3f} ms per frame (same pass, profiler on, CUDA "
          f"activity only): device "
          f"idle {(1 - busy / span) * 100:.1f} %; {smi}", flush=True)
    for dev_us, count, key in rows[:PROFILE_TOP]:
        print(f"phase 6: {dev_us / nv / 1e3:9.4f} ms/frame x{count / nv:<6.1f}"
              f" {key[:100]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
