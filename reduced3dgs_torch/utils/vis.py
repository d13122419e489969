"""Visualisation and debugging utilities of the port (developer tools).

The counterpart of reduced3dgs_tpu/utils/vis.py: loss-image GIF dumps
with the turbo colormap, tensor dumps, the ellipsoid shape classifier and
the COLMAP-text camera-path reader.  Every function takes numpy arrays
or torch tensors (on any device); images are channel-last (H, W, C).

The turbo colormap is matplotlib's, carried as its 256-entry table with
matplotlib's index rule, so the port needs no matplotlib.  The two
functions that write JPEG frames and GIFs (``save_gif_images``,
``generate_gif``) and ``save_image`` and its callers need Pillow, which
they import when called.
"""

from __future__ import annotations

import os
from collections import namedtuple
from pathlib import Path

import numpy as np

# matplotlib's "turbo" (Google's colormap, the table the reference embeds):
# 256 RGB entries, each channel in units of 1e-5 (the published values
# have five decimals, so k / 1e5 gives matplotlib's float64 bit for bit)
_TURBO_E5 = """
18995 7176 23217 19483 8339 26149 19956 9498 29024 20415 10652 31844
20860 11802 34607 21291 12947 37314 21708 14087 39964 22111 15223 42558
22500 16354 45096 22875 17481 47578 23236 18603 50004 23582 19720 52373
23915 20833 54686 24234 21941 56942 24539 23044 59142 24830 24143 61286
25107 25237 63374 25369 26327 65406 25618 27412 67381 25853 28492 69300
26074 29568 71162 26280 30639 72968 26473 31706 74718 26652 32768 76412
26816 33825 78050 26967 34878 79631 27103 35926 81156 27226 36970 82624
27334 38008 84037 27429 39043 85393 27509 40072 86692 27576 41097 87936
27628 42118 89123 27667 43134 90254 27691 44145 91328 27701 45152 92347
27698 46153 93309 27680 47151 94214 27648 48144 95064 27603 49132 95857
27543 50115 96594 27469 51094 97275 27381 52069 97899 27273 53040 98461
27106 54015 98930 26878 54995 99303 26592 55979 99583 26252 56967 99773
25862 57958 99876 25425 58950 99896 24946 59943 99835 24427 60937 99697
23874 61931 99485 23288 62923 99202 22676 63913 98851 22039 64901 98436
21382 65886 97959 20708 66866 97423 20021 67842 96833 19326 68812 96190
18625 69775 95498 17923 70732 94761 17223 71680 93981 16529 72620 93161
15844 73551 92305 15173 74472 91416 14519 75381 90496 13886 76279 89550
13278 77165 88580 12698 78037 87590 12151 78896 86581 11639 79740 85559
11167 80569 84525 10738 81381 83484 10357 82177 82437 10026 82955 81389
9750 83714 80342 9532 84455 79299 9377 85175 78264 9287 85875 77240 9267
86554 76230 9320 87211 75237 9451 87844 74265 9662 88454 73316 9958
89040 72393 10342 89600 71500 10815 90142 70599 11374 90673 69651 12014
91193 68660 12733 91701 67627 13526 92197 66556 14391 92680 65448 15323
93151 64308 16319 93609 63137 17377 94053 61938 18491 94484 60713 19659
94901 59466 20877 95304 58199 22142 95692 56914 23449 96065 55614 24797
96423 54303 26180 96765 52981 27597 97092 51653 29042 97403 50321 30513
97697 48987 32006 97974 47654 33517 98234 46325 35043 98477 45002 36581
98702 43688 38127 98909 42386 39678 99098 41098 41229 99268 39826 42778
99419 38575 44321 99551 37345 45854 99663 36140 47375 99755 34963 48879
99828 33816 50362 99879 32701 51822 99910 31622 53255 99919 30581 54658
99907 29581 56026 99873 28623 57357 99817 27712 58646 99739 26849 59891
99638 26038 61088 99514 25280 62233 99366 24579 63323 99195 23937 64362
98999 23356 65394 98775 22835 66428 98524 22370 67462 98246 21960 68494
97941 21602 69525 97610 21294 70553 97255 21032 71577 96875 20815 72596
96470 20640 73610 96043 20504 74617 95593 20406 75617 95121 20343 76608
94627 20311 77591 94113 20310 78563 93579 20336 79524 93025 20386 80473
92452 20459 81410 91861 20552 82333 91253 20663 83241 90627 20788 84133
89986 20926 85010 89328 21074 85868 88655 21230 86709 87968 21391 87530
87267 21555 88331 86553 21719 89112 85826 21880 89870 85087 22038 90605
84337 22188 91317 83576 22328 92004 82806 22456 92666 82025 22570 93301
81236 22667 93909 80439 22744 94489 79634 22800 95039 78823 22831 95560
78005 22836 96049 77181 22811 96507 76352 22754 96931 75519 22663 97323
74682 22536 97679 73842 22369 98000 73000 22161 98289 72140 21918 98549
71250 21650 98781 70330 21358 98986 69382 21043 99163 68408 20706 99314
67408 20348 99438 66386 19971 99535 65341 19577 99607 64277 19165 99654
63193 18738 99675 62093 18297 99672 60977 17842 99644 59846 17376 99593
58703 16899 99517 57549 16412 99419 56386 15918 99297 55214 15417 99153
54036 14910 98987 52854 14398 98799 51667 13883 98590 50479 13367 98360
49291 12849 98108 48104 12332 97837 46920 11817 97545 45740 11305 97234
44565 10797 96904 43399 10294 96555 42241 9798 96187 41093 9310 95801
39958 8831 95398 38836 8362 94977 37729 7905 94538 36638 7461 94084
35566 7031 93612 34513 6616 93125 33482 6218 92623 32473 5837 92105
31489 5475 91572 30530 5134 91024 29599 4814 90463 28696 4516 89888
27824 4243 89298 26981 3993 88691 26152 3753 88066 25334 3521 87422
24526 3297 86760 23730 3082 86079 22945 2875 85380 22170 2677 84662
21407 2487 83926 20654 2305 83172 19912 2131 82399 19182 1966 81608
18462 1809 80799 17753 1660 79971 17055 1520 79125 16368 1387 78260
15693 1264 77377 15028 1148 76476 14374 1041 75556 13731 942 74617 13098
851 73661 12477 769 72686 11867 695 71692 11268 629 70680 10680 571
69650 10102 522 68602 9536 481 67535 8980 449 66449 8436 424 65345 7902
408 64223 7380 401 63082 6868 401 61923 6367 410 60746 5878 427 59550
5399 453 58336 4931 486 57103 4474 529 55852 4028 579 54583 3593 638
53295 3169 705 51989 2756 780 50664 2354 863 49321 1963 955 47960 1583
1055
"""
TURBO = (np.array(_TURBO_E5.split(), np.int64) / 100000.0).reshape(256, 3)


def _np(a, dtype=None):
    """A numpy array of a numpy array, a torch tensor or a scalar."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def normalise_tensor(a):
    """Min-max normalise to [0, 1] (visualisation_utils.py:27-28)."""
    a = _np(a, np.float32)
    span = a.max() - a.min()
    return (a - a.min()) / (span if span > 0 else 1.0)


def colormap_turbo(values):
    """Map [0, 1] scalars to turbo RGB (float64), as matplotlib's
    colormaps["turbo"](values)[..., :3] does: values are clipped to
    [0, 1], a float x picks entry int(x * 256) computed in its own type
    (1.0 picks the last), an integer is an index, NaN gives black."""
    xa = np.array(np.clip(_np(values), 0, 1), copy=True)
    n = TURBO.shape[0]
    if xa.dtype.kind == "f":
        xa *= n
        xa[xa == n] = n - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    rgb = TURBO.take(np.clip(idx, 0, n - 1), axis=0)
    rgb[bad] = 0.0
    return rgb


def save_image(path, array):
    """(H, W, 3) or (H, W) float [0, 1] -> image file (Pillow)."""
    from PIL import Image

    a = _np(array)
    if a.ndim == 2:
        a = np.repeat(a[:, :, None], 3, 2)
    Image.fromarray((np.clip(a, 0, 1) * 255).astype(np.uint8)).save(path)


def save_loss_image(path, pred, gt):
    """|pred - gt| per pixel with the turbo colormap."""
    err = np.abs(_np(pred) - _np(gt)).mean(axis=-1)
    save_image(path, colormap_turbo(err / max(err.max(), 1e-8)))


def save_gif_images(path, loss_img, image, index, iteration, loss_name,
                    normalise=False):
    """One GIF frame, written as a JPEG: [colormapped loss | rendered
    image] side by side (visualisation_utils.py:8-14).  loss_img: (H, W)
    or (H, W, C) per-pixel loss; image: (H, W, 3) in [0, 1]."""
    loss_img = _np(loss_img, np.float32)
    if loss_img.ndim == 3:
        loss_img = loss_img.mean(axis=-1)
    if normalise:
        loss_img = normalise_tensor(loss_img)
    lhs = colormap_turbo(loss_img)
    combined = np.concatenate([lhs, np.clip(_np(image), 0, 1)], axis=1)
    save_image(os.path.join(path, f"{loss_name}_{index}_{iteration}.jpg"),
               combined)


def generate_gif(path, index):
    """Assemble the frames save_gif_images wrote for view `index` into
    gif_<index>.gif, ordered by iteration
    (visualisation_utils.py:16-25).  Returns the GIF's path."""
    from PIL import Image

    def get_iteration(name):
        return int(name[:-4].split("_")[-1])

    names = sorted(
        (n for n in os.listdir(path)
         if f"_{index}_" in n and n.endswith(".jpg")),
        key=get_iteration)
    images = [Image.open(os.path.join(path, n)) for n in names]
    if not images:
        raise FileNotFoundError(f"no frames for index {index} in {path}")
    out = os.path.join(path, f"gif_{index}.gif")
    images[0].save(out, save_all=True, append_images=images[1:], loop=0,
                   duration=200)
    return out


def save_tensor(path, a, use_colormap=False):
    """Dump any (H, W[, 3]) tensor as an image, optionally colormapped:
    the headless counterpart of the reference's show_tensor
    (visualisation_utils.py:30-38)."""
    a = normalise_tensor(a)
    if use_colormap:
        a = colormap_turbo(a)
    save_image(path, a)


def compute_shape(scale):
    """Ellipsoid shape classifier with the reference's thresholds
    (visualisation_utils.py:67-77): ACTIVATED scales (N, 3) -> 0 = blob,
    1 = disc / pancake, 2 = needle.  With s_max / s_min > 5: needle when
    the middle axis stays small relative to the elongation (rest / min <
    (max / min) / 3), disc when it tracks it (rest / min > (max / min) /
    2)."""
    scale = _np(scale, np.float32)
    max_scale = scale.max(axis=1)
    min_scale = scale.min(axis=1)
    rest_scale = scale.sum(axis=1) - min_scale - max_scale
    shape = np.zeros(scale.shape[0], dtype=np.int64)
    elong = max_scale / min_scale
    rest = rest_scale / min_scale
    shape[np.logical_and(elong > 5, rest < elong / 3)] = 2
    shape[np.logical_and(elong > 5, rest > elong / 2)] = 1
    return shape


def classify_ellipsoids(scales_raw):
    """compute_shape over RAW (log-space) pool scales."""
    return compute_shape(np.exp(_np(scales_raw)))


VisCamera = namedtuple("VisCamera",
                       ["position", "direction", "up", "fov", "aspect"])


def read_camera_path(path: str):
    """COLMAP-text camera path -> list of VisCamera (position, forward,
    up, vertical fov, aspect) for fly-through rendering
    (visualisation_utils.py:79-127).  Reads cameras.txt (PINHOLE-style
    rows: id model w h fx fy cx cy) and images.txt (qvec wxyz, tvec)."""
    from reduced3dgs_torch.data.colmap import qvec2rotmat

    cameras_file = Path(path) / "cameras.txt"
    images_file = Path(path) / "images.txt"
    if not cameras_file.exists() or not images_file.exists():
        raise FileNotFoundError(f"cameras.txt/images.txt not in {path}")

    params = {}
    with open(cameras_file) as f:
        for line in f:
            if not line.strip() or line[0] == "#":
                continue
            t = line.split()
            params[int(t[0])] = (int(t[2]), int(t[3]), float(t[4]),
                                 float(t[5]))

    # the reference flips into its viewer convention: y / z negated
    conv = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    cams = []
    with open(images_file) as f:
        for line in f:
            if not line.strip() or line[0] == "#":
                continue
            t = line.split()
            if len(t) < 9:
                continue  # 2D-point lines
            q = np.array([float(x) for x in t[1:5]])
            tvec = np.array([float(x) for x in t[5:8]])
            w, h, fx, fy = params[int(t[8])]
            rot = qvec2rotmat(q)
            orientation = rot.T @ conv
            position = -(orientation @ conv @ tvec)
            fov = 2.0 * np.arctan(0.5 * h / fy)
            cams.append(VisCamera(position, -orientation[:, -1],
                                  orientation[:, 1], fov, w / h))
    return cams
