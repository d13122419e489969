"""Seeded scenes at published sizes, made on the device: the primitives
of an unbounded 360-degree capture, its cameras, a smooth viewing path
and smooth ground-truth images.

Frozen with the benchmark (written for it at commit d31b96e; a later
change to the program does not change it).  Everything is a function of
the configuration's file and the seed: the same seed gives the same
tensors on the same device.  The layout follows the published captures
(Mip-NeRF 360, Tanks and Temples): a dense central region that the
cameras orbit, inside a sparse background shell.  What the published
sources leave open (the sizes of the primitives, their opacities and
colours, the orbit's radius) is the configuration's `assumed` block.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ZNEAR = 0.01
ZFAR = 100.0
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def generator(seed: int, device, stream: int) -> torch.Generator:
    """One generator per purpose, so that adding a draw to one purpose
    leaves the others' draws as they were."""
    mixed = (int(seed) * 1000003 + stream * 7919) % (1 << 62)
    return torch.Generator(device=device).manual_seed(mixed)


def _normal(shape, g, device):
    return torch.randn(shape, generator=g, device=device)


def _uniform(shape, g, device):
    return torch.rand(shape, generator=g, device=device)


def degree_counts(cfg) -> list:
    """Primitives of SH degree 0..3, from the configuration's histogram
    (shares that sum to 1) over its primitive count; the remainder goes to
    the top degree."""
    n = cfg["primitives"]
    shares = cfg["assumed"]["sh_degree_shares"]
    counts = [int(math.floor(n * s)) for s in shares[:-1]]
    return counts + [n - sum(counts)]


def primitives(cfg, seed: int, device):
    """The scene's primitives as float32 leaves over the configuration's
    capacity (rows past the primitive count dead: zero, identity
    rotation), with `degrees` (int32) and `alive` (bool).  Rows are
    grouped by SH degree, lowest first."""
    a = cfg["assumed"]
    n = cfg["primitives"]
    cap = cfg["capacity"]
    g = generator(seed, device, 1)
    centre_n = int(n * a["central_share"])
    # central region: a ball of radius central_radius; shell: between
    # shell_radii, uniform in direction
    u = _uniform((n,), g, device)
    d = _normal((n, 3), g, device)
    d = d / d.norm(dim=1, keepdim=True).clamp(min=1e-12)
    r0, (r1, r2) = a["central_radius"], a["shell_radii"]
    radius = torch.where(
        torch.arange(n, device=device) < centre_n,
        r0 * u.pow(1.0 / 3.0), r1 + (r2 - r1) * u)
    # shuffle so that the central and shell rows mix across SH degrees
    perm = torch.randperm(n, generator=g, device=device)
    radius = radius[perm]
    xyz = d * radius[:, None]
    # sizes: log-normal around a base that grows with the distance from
    # the centre beyond the central region (far primitives are larger)
    base = a["scale_base"] * torch.clamp(radius / r0, min=1.0)
    scaling = (torch.log(base)[:, None]
               + a["scale_log_sigma"] * _normal((n, 3), g, device))
    # unit quaternions, uniform over rotations: a trained model's raw
    # quaternions start at (1, 0, 0, 0) and keep a norm near 1
    rotation = _normal((n, 4), g, device)
    rotation = rotation / rotation.norm(dim=1, keepdim=True).clamp(min=1e-12)
    opacity = a["opacity_mu"] + a["opacity_sigma"] * _normal((n, 1), g,
                                                             device)
    dead = _uniform((n, 1), g, device) < a["dead_share"]
    opacity = torch.where(dead, torch.full_like(opacity, a["dead_opacity"]),
                          opacity)
    dc = a["dc_sigma"] * _normal((n, 1, 3), g, device)
    rest = a["rest_sigma"] * _normal((n, 15, 3), g, device)
    degrees = torch.cat([torch.full((c,), deg, dtype=torch.int32,
                                    device=device)
                         for deg, c in enumerate(degree_counts(cfg))])
    band = torch.arange(1, 16, device=device).float().sqrt().floor()
    rest = rest * (band[None, :] <= degrees[:, None].float())[..., None]

    def pad(x):
        out = torch.zeros((cap,) + x.shape[1:], dtype=x.dtype, device=device)
        out[:n] = x
        return out

    rot = pad(rotation)
    rot[n:, 0] = 1.0
    leaves = dict(xyz=pad(xyz), features_dc=pad(dc), features_rest=pad(rest),
                  scaling=pad(scaling), rotation=rot, opacity=pad(opacity))
    leaves["degrees"] = pad(degrees)
    leaves["alive"] = torch.arange(cap, device=device) < n
    return leaves


def moments(cfg, seed: int, leaves):
    """Adam's first and second moments of a state late in training: per
    element of an alive row, first moments 0.1 s N(0, 1) and second
    moments (10 s)^2 (1 + N(0, 1)^2) / 2 for the leaf's gradient scale s
    (the configuration's `adam_grad_rms`), zero on dead rows; Adam's
    steps are then about a percent of the learning rate."""
    rms = cfg["assumed"]["adam_grad_rms"]
    dev = leaves["xyz"].device
    g = generator(seed, dev, 2)
    alive = leaves["alive"]
    mu, nu = {}, {}
    for k in LEAVES:
        s = rms[k]
        shape = leaves[k].shape
        m = 0.1 * s * _normal(shape, g, dev)
        v = (10 * s) ** 2 * 0.5 * (1.0 + _normal(shape, g, dev).square())
        keep = alive.view((-1,) + (1,) * (len(shape) - 1))
        mu[k] = torch.where(keep, m, 0.0)
        nu[k] = torch.where(keep, v, 0.0)
    return mu, nu


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """(R camera-to-world with columns right, down, forward; T
    world-to-camera), as a COLMAP camera stores them."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    return R, -R.T @ eye


def orbit(cfg, count: int, rng: np.random.Generator):
    """`count` camera poses around the centre (R, T, eye), azimuth evenly
    spaced with a seeded phase, at seeded distances and elevations in the
    configuration's ranges."""
    a = cfg["assumed"]
    d0, d1 = a["camera_distance"]
    e0, e1 = a["camera_elevation_deg"]
    phase = rng.uniform(0, 2 * math.pi)
    poses = []
    for i in range(count):
        az = phase + 2 * math.pi * i / count
        el = math.radians(e0 + (e1 - e0) * rng.uniform())
        dist = d0 + (d1 - d0) * rng.uniform()
        eye = dist * np.array([math.cos(el) * math.cos(az), -math.sin(el),
                               math.cos(el) * math.sin(az)])
        R, T = look_at(eye, np.zeros(3))
        poses.append((R, T, eye))
    return poses


def fov_y(cfg) -> float:
    fx = math.radians(cfg["assumed"]["fov_x_deg"])
    return 2 * math.atan(math.tan(fx / 2) * cfg["height"] / cfg["width"])


def training_poses(cfg, seed: int):
    """The train cameras' poses (the configuration's `train_cameras`)."""
    rng = np.random.default_rng([int(seed), 3])
    return orbit(cfg, cfg["train_cameras"], rng)


def viewing_path(cfg, seed: int, count: int):
    """A smooth closed path of `count` poses at the test cameras'
    distances: one turn around the centre, the elevation and the
    distance swinging twice and three times a turn."""
    a = cfg["assumed"]
    rng = np.random.default_rng([int(seed), 4])
    d0, d1 = a["camera_distance"]
    e0, e1 = a["camera_elevation_deg"]
    p0, p1, p2 = rng.uniform(0, 2 * math.pi, 3)
    poses = []
    for i in range(count):
        t = 2 * math.pi * i / count
        el = math.radians(e0 + (e1 - e0) * 0.5 * (1 + math.sin(2 * t + p1)))
        dist = d0 + (d1 - d0) * 0.5 * (1 + math.sin(3 * t + p2))
        az = p0 + t
        eye = dist * np.array([math.cos(el) * math.cos(az), -math.sin(el),
                               math.cos(el) * math.sin(az)])
        R, T = look_at(eye, np.zeros(3))
        poses.append((R, T, eye))
    return poses


def matrices(R, T, fov_x, fov_yv):
    """(world-to-view, full projection) 4x4, transposed (row vectors),
    float32, as the published reference builds them (znear 0.01, zfar
    100, depth in [0, 1])."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = R.T
    rt[:3, 3] = T
    rt[3, 3] = 1.0
    w2v = rt.astype(np.float32)
    tx, ty = math.tan(fov_x / 2), math.tan(fov_yv / 2)
    p = np.zeros((4, 4), np.float32)
    p[0, 0] = 1.0 / tx
    p[1, 1] = 1.0 / ty
    p[3, 2] = 1.0
    p[2, 2] = ZFAR / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    view = w2v.T.astype(np.float32)
    return view, (view @ p.T).astype(np.float32)


def ground_truth(cfg, seed: int, index: int, device):
    """A smooth (H, W, 3) image in [0, 1]: three seeded plane waves per
    channel around mid-grey."""
    g = generator(seed, device, 1000 + index)
    h, w = cfg["height"], cfg["width"]
    ys = torch.linspace(0, 1, h, device=device)[:, None, None]
    xs = torch.linspace(0, 1, w, device=device)[None, :, None]
    img = torch.full((h, w, 3), 0.5, device=device)
    for _ in range(3):
        f = 0.5 + 2.5 * _uniform((2, 3), g, device)
        ph = 2 * math.pi * _uniform((3,), g, device)
        amp = 0.15 * _uniform((3,), g, device)
        img = img + amp * torch.sin(2 * math.pi * (f[0] * xs + f[1] * ys)
                                    + ph)
    return img.clamp(0.0, 1.0)
