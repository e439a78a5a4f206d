"""Dataset readers: synthetic rendered sequences + TUM RGB-D directories.

The synthetic renderer draws a two-plane textured world (back wall + floor)
through the pinhole camera with exact ground-truth poses — sufficient to
exercise the full pipeline (feature tracking, triangulation, BA, loop
closure) with measurable ATE, in an environment with no dataset downloads.

The TUM reader consumes the standard `rgb.txt` index of a TUM RGB-D
sequence directory (the evaluation format targeted by BASELINE.md).
"""
from __future__ import annotations

import os

import numpy as np
from scipy.spatial.transform import Rotation

from ..utils.cv import require_cv2


def _cubic_weights(n_in: int, n_out: int, a: float = -0.75) -> np.ndarray:
    """(n_out, n_in) bicubic resampling matrix, cv2.INTER_CUBIC's kernel:
    half-pixel-centred sampling, Keys a=-0.75, replicated border."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x).astype(np.int64)
    f = x - x0
    wts = np.zeros((n_out, n_in))
    for o in range(4):
        t = np.abs(f - (o - 1))
        k = np.where(t <= 1, ((a + 2) * t - (a + 3)) * t * t + 1,
                     np.where(t < 2, ((a * t - 5 * a) * t + 8 * a) * t - 4 * a, 0.0))
        np.add.at(wts, (np.arange(n_out), np.clip(x0 - 1 + o, 0, n_in - 1)), k)
    return wts


def _resize_cubic(img: np.ndarray, size: int) -> np.ndarray:
    """Square bicubic upsampling of a float image to (size, size)."""
    wy = _cubic_weights(img.shape[0], size)
    wx = _cubic_weights(img.shape[1], size)
    return (wy @ img.astype(np.float64) @ wx.T).astype(np.float32)


def _gaussian_blur_3x3(img: np.ndarray) -> np.ndarray:
    """3x3 Gaussian blur, sigma 0.7, of a uint8 image, bit-exact with
    cv2.GaussianBlur: taps (54, 148, 54)/256 in fixed point, reflect-101
    border, rounded once after both passes."""
    k = (54, 148, 54)
    p = np.pad(img.astype(np.int64), 1, mode="reflect")
    rows = k[0] * p[:, :-2] + k[1] * p[:, 1:-1] + k[2] * p[:, 2:]
    out = k[0] * rows[:-2] + k[1] * rows[1:-1] + k[2] * rows[2:]
    return ((out + (1 << 15)) >> 16).astype(np.uint8)


def _perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography taking the 4 points `src` to `dst` (h33 = 1)."""
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src.astype(np.float64), dst.astype(np.float64))):
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _warp_transparent(tex: np.ndarray, H: np.ndarray, img: np.ndarray) -> None:
    """Paint `tex` into `img` (uint8, in place) through the homography H
    (texture px -> image px): bilinear inverse warp in float32 where a
    source tap outside the texture takes the destination pixel's own value,
    and pixels that map wholly outside the texture stay untouched
    (cv2.warpPerspective with BORDER_TRANSPARENT)."""
    h_img, w_img = img.shape
    th, tw = tex.shape
    # footprint of the texture grown by one texel: the border pixels that
    # blend with the destination lie in that ring
    corners = np.array([[-1, -1, 1], [tw, -1, 1], [tw, th, 1], [-1, th, 1]],
                       np.float64) @ H.T
    uv = corners[:, :2] / corners[:, 2:]
    x0 = max(int(np.floor(uv[:, 0].min())), 0)
    x1 = min(int(np.ceil(uv[:, 0].max())) + 1, w_img)
    y0 = max(int(np.floor(uv[:, 1].min())), 0)
    y1 = min(int(np.ceil(uv[:, 1].max())) + 1, h_img)
    if x0 >= x1 or y0 >= y1:
        return
    m = np.linalg.inv(H)
    xs = np.arange(x0, x1, dtype=np.float64)[None, :]
    ys = np.arange(y0, y1, dtype=np.float64)[:, None]
    w = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    u = ((m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) / w).astype(np.float32)
    v = ((m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) / w).astype(np.float32)
    sx = np.floor(u).astype(np.int64)
    sy = np.floor(v).astype(np.int64)
    hit = (sx >= -1) & (sx < tw) & (sy >= -1) & (sy < th)
    if not hit.any():
        return
    sx, sy, u, v = sx[hit], sy[hit], u[hit], v[hit]
    ax = u - sx.astype(np.float32)
    ay = v - sy.astype(np.float32)
    region = img[y0:y1, x0:x1]
    own = region[hit].astype(np.float32)
    texf = tex.astype(np.float32)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < th) & (xx >= 0) & (xx < tw)
        return np.where(inside, texf[np.clip(yy, 0, th - 1), np.clip(xx, 0, tw - 1)], own)

    top = (1 - ax) * tap(sy, sx) + ax * tap(sy, sx + 1)
    bot = (1 - ax) * tap(sy + 1, sx) + ax * tap(sy + 1, sx + 1)
    region[hit] = np.clip(np.rint((1 - ay) * top + ay * bot), 0, 255).astype(np.uint8)


def _make_texture(rng, size=1024, blobs=900):
    """Multi-scale, NON-repetitive texture.

    A statistically uniform field of similar-size blobs aliases: when the
    inter-frame image displacement approaches the blob spacing, window
    matching locks onto the wrong-but-consistent neighbor and the tracker
    diverges confidently. Mixing octave noise (unique low-frequency
    context) with blobs spanning 6..160 px breaks that symmetry.
    """
    # low-frequency octave noise gives every region a unique large-scale context
    tex = np.zeros((size, size), np.float32)
    for octave, amp in [(8, 60.0), (32, 40.0), (128, 25.0)]:
        small = rng.normal(0, 1, (octave, octave)).astype(np.float32)
        tex += amp * _resize_cubic(small, size)
    tex += 128.0
    # blobs with widely varying scales and shapes
    for _ in range(blobs):
        w = int(rng.integers(6, 160))
        h = int(rng.integers(6, 160))
        x = int(rng.integers(0, size - w))
        y = int(rng.integers(0, size - h))
        base = rng.uniform(20, 235)
        gx, gy = rng.uniform(-2, 2, 2)
        patch = base + gx * np.arange(w)[None, :] + gy * np.arange(h)[:, None]
        alpha = rng.uniform(0.5, 1.0)
        if rng.uniform() < 0.5:
            tex[y : y + h, x : x + w] = (1 - alpha) * tex[y : y + h, x : x + w] + alpha * patch
        else:
            yy, xx = np.mgrid[0:h, 0:w]
            m = ((yy - h / 2) ** 2 / (h / 2) ** 2 + (xx - w / 2) ** 2 / (w / 2) ** 2) <= 1
            reg = tex[y : y + h, x : x + w]
            reg[m] = (1 - alpha) * reg[m] + alpha * np.broadcast_to(patch, reg.shape)[m]
    tex += rng.normal(0, 4.0, tex.shape)
    tex = np.clip(tex, 0, 255).astype(np.uint8)
    return _gaussian_blur_3x3(tex)


def _tile_quad(corners: np.ndarray, tex: np.ndarray, n: int = 10):
    """Split a textured planar quad into an n x n grid of sub-quads, each
    with its texture sub-rectangle (bilinear corner interpolation — exact
    for planar quads with the affine texture parameterization used here)."""
    if n <= 1:
        return [(corners, tex)]
    size = tex.shape[0]
    c00, c10, c11, c01 = corners[0], corners[1], corners[2], corners[3]

    def lerp(u, v):
        a = c00 * (1 - u) + c10 * u
        b = c01 * (1 - u) + c11 * u
        return a * (1 - v) + b * v

    out = []
    for j in range(n):
        v0, v1 = j / n, (j + 1) / n
        y0, y1 = int(round(v0 * (size - 1))), int(round(v1 * (size - 1))) + 1
        for i in range(n):
            u0, u1 = i / n, (i + 1) / n
            x0, x1 = int(round(u0 * (size - 1))), int(round(u1 * (size - 1))) + 1
            sub = np.stack([lerp(u0, v0), lerp(u1, v0), lerp(u1, v1), lerp(u0, v1)])
            out.append((sub.astype(np.float32), tex[y0:y1, x0:x1]))
    return out


class SyntheticSequence:
    """Renders a textured two-plane world from a ground-truth trajectory.

    Planes: back wall (z = wall_z, x in [-4,4], y in [-3,3]) and floor
    (y = floor_y, x in [-4,4], z in [1, wall_z]). Rendering = homography
    warp of each plane's texture into the camera (exact pinhole geometry).
    """

    def __init__(
        self,
        n_frames: int = 120,
        width: int = 640,
        height: int = 480,
        K4=(500.0, 500.0, 320.0, 240.0),
        trajectory: str = "xyz",
        seed: int = 0,
        wall_z: float = 3.0,
        floor_y: float = 1.2,
    ):
        rng = np.random.default_rng(seed)
        self.width, self.height = width, height
        self.K = np.array(
            [[K4[0], 0, K4[2]], [0, K4[1], K4[3]], [0, 0, 1]], np.float64
        )
        self.K4 = np.array(K4, np.float32)
        self.wall_z = wall_z
        self.floor_y = floor_y
        # A "room": back wall + two side walls + floor. Depth diversity is
        # essential — a single distant plane leaves the rotation/translation
        # gauge nearly unobservable and the whole reconstruction slides.
        fy = floor_y
        wz = wall_z
        # the orbit trajectory sweeps a full 360°, so its world must be a
        # CLOSED room (walls in every direction); the other trajectories
        # keep the original open-front room so their renders (and recorded
        # baselines) are unchanged
        z_near = -1.5 if trajectory == "orbit" else 0.6
        # Geometry matches the TUM fr1 regime the baseline targets: scene
        # depth ~1-3 m. (A 6 m wall with ~0.1 m baselines gives ~0.3 m
        # triangulation noise per point — z^2/(f b) sigma_px — which no
        # SLAM system survives; depth accuracy is a property of the scene.)
        hw = 2.0  # room half-width
        self.quads = [
            # (corners [4x3, painter order far->near], texture)
            (np.array([[-hw, -1.5, wz], [hw, -1.5, wz], [hw, fy, wz], [-hw, fy, wz]], np.float32),
             _make_texture(rng)),
            (np.array([[-hw, -1.5, wz], [-hw, fy, wz], [-hw, fy, z_near], [-hw, -1.5, z_near]], np.float32),
             _make_texture(np.random.default_rng(seed + 2))),
            (np.array([[hw, -1.5, wz], [hw, fy, wz], [hw, fy, z_near], [hw, -1.5, z_near]], np.float32),
             _make_texture(np.random.default_rng(seed + 3))),
            (np.array([[-hw, fy, wz], [hw, fy, wz], [hw, fy, z_near], [-hw, fy, z_near]], np.float32),
             _make_texture(np.random.default_rng(seed + 1))),
        ]
        if trajectory == "orbit":
            # front wall closing the room (faces +z; painter order safe —
            # it never occludes the others from inside)
            self.quads.append((
                np.array([[hw, -1.5, z_near], [-hw, -1.5, z_near],
                          [-hw, fy, z_near], [hw, fy, z_near]], np.float32),
                _make_texture(np.random.default_rng(seed + 4)),
            ))
        # Tile the room quads: the renderer drops any quad with a corner
        # behind the near plane, and a camera INSIDE the room (orbit) always
        # has some wall partially behind it — untiled, whole walls vanish
        # and some view angles render black. Tiles lose only thin slivers.
        self.quads = [t for q in self.quads for t in _tile_quad(*q, n=10)]
        # "Furniture": fronto-parallel panels at spread depths. Without
        # close-range structure, the matched features' depth relief is too
        # shallow and a small rotation is absorbed by a compensating
        # translation at <0.5 px residual — the pose slides. Panels at
        # 1.2-2.4 m pin that direction. Painter order: far to near.
        prng = np.random.default_rng(seed + 7)
        panels = []
        for depth in [2.5, 2.2, 1.9, 1.6, 1.35]:
            for _ in range(2):
                cx_p = float(prng.uniform(-1.3, 1.3))
                cy_p = float(prng.uniform(-0.6, fy - 0.3))
                w2 = float(prng.uniform(0.25, 0.45))
                h2 = float(prng.uniform(0.2, 0.4))
                quad = np.array(
                    [[cx_p - w2, cy_p - h2, depth], [cx_p + w2, cy_p - h2, depth],
                     [cx_p + w2, cy_p + h2, depth], [cx_p - w2, cy_p + h2, depth]],
                    np.float32,
                )
                panels.append((quad, _make_texture(prng, size=256, blobs=120)))
        self.quads.extend(panels)
        self.poses = self._trajectory(n_frames, trajectory)
        self.timestamps = np.arange(n_frames) / 30.0

    def __len__(self):
        return len(self.poses)

    def _trajectory(self, n, kind):
        poses = []
        for i in range(n):
            ph = i / max(n - 1, 1)
            if kind == "xyz":
                # oscillating translation (TUM fr1/xyz-like), small rotation
                t_wc = np.array(
                    [0.35 * np.sin(2 * np.pi * ph * 2),
                     0.15 * np.sin(2 * np.pi * ph * 3),
                     0.25 * np.sin(2 * np.pi * ph)],
                )
                rot = Rotation.from_euler(
                    "yxz", [0.06 * np.sin(2 * np.pi * ph * 2), 0.03 * np.sin(2 * np.pi * ph * 3), 0.0]
                )
            elif kind == "forward":
                t_wc = np.array([0.0, 0.0, 0.02 * i])
                rot = Rotation.identity()
            elif kind == "loop":
                # a genuine loop: the camera pans ~60deg away (start view
                # fully leaves the frustum, covisibility chain breaks after
                # keyframe culling) and comes back to the starting view
                t_wc = np.array(
                    [0.8 * np.sin(2 * np.pi * ph),
                     0.03 * np.sin(4 * np.pi * ph),
                     0.2 * np.sin(2 * np.pi * ph)],
                )
                rot = Rotation.from_euler("y", 1.05 * np.sin(2 * np.pi * ph))
            elif kind == "orbit":
                # full 360° sweep with REAL baseline (monocular triangulation
                # needs translation): the camera rides a circle of radius r
                # inside the closed room, always facing outward; the start
                # view leaves the frustum entirely and returns at the end —
                # the canonical loop-closure benchmark
                theta = 2 * np.pi * ph
                r = 0.7
                t_wc = np.array(
                    [r * np.sin(theta),
                     0.02 * np.sin(4 * np.pi * ph),
                     r * np.cos(theta)],
                )
                rot = Rotation.from_euler("y", theta)
            else:
                raise ValueError(kind)
            R_wc = rot.as_matrix()
            # world->cam: R = R_wc^T, t = -R_wc^T t_wc
            R = R_wc.T
            t = -R @ t_wc
            poses.append((R.astype(np.float32), t.astype(np.float32)))
        return poses

    def _plane_homography(self, R, t, corners_world, tex_shape):
        """Homography mapping texture pixels -> image pixels for a quad."""
        th, tw = tex_shape[:2]
        src = np.array(
            [[0, 0], [tw - 1, 0], [tw - 1, th - 1], [0, th - 1]],
            np.float32,
        )
        xc = corners_world @ R.T + t
        if (xc[:, 2] <= 0.05).any():
            return None
        uv = (xc @ self.K.T.astype(np.float32))
        uv = uv[:, :2] / uv[:, 2:]
        return _perspective_transform(src, uv.astype(np.float32))

    def render(self, i: int) -> np.ndarray:
        R, t = self.poses[i]
        img = np.zeros((self.height, self.width), np.uint8)
        for corners, tex in self.quads:
            H = self._plane_homography(R, t, corners, tex.shape)
            if H is not None:
                _warp_transparent(tex, H, img)
        return img

    def get(self, i: int):
        return self.render(i), float(self.timestamps[i]), self.poses[i]


class TumDataset:
    """TUM RGB-D sequence directory reader (rgb.txt + rgb/*.png)."""

    def __init__(self, path: str):
        self.path = path
        self.entries: list[tuple[float, str]] = []
        with open(os.path.join(path, "rgb.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                self.entries.append((float(ts), rel))

    def __len__(self):
        return len(self.entries)

    def get(self, i: int):
        ts, rel = self.entries[i]
        cv2 = require_cv2()
        img = cv2.imread(os.path.join(self.path, rel), cv2.IMREAD_GRAYSCALE)
        return img, ts, None


class PhotometricAugment:
    """Photometric degradation wrapper over a sequence — the robustness
    bridge between the clean renderer and real camera data (motion blur,
    sensor noise, exposure changes, vignetting are what a real fr1-style
    handheld sequence adds on top of geometry; the reference is validated
    only on such data, README.md §5).

    Effects (all deterministic in the seed):
      * motion blur: directional box blur along the dominant image-plane
        motion between consecutive ground-truth poses (length `blur_px`);
      * sensor noise: additive Gaussian, sigma `noise_sigma` (DN);
      * exposure ramp: slow sinusoidal gain in [1-a, 1+a], a=`exposure_amp`
        (auto-exposure hunting);
      * vignetting: radial falloff, `vignette` fraction at the corners.
    """

    def __init__(self, base, blur_px: float = 0.0, noise_sigma: float = 0.0,
                 exposure_amp: float = 0.0, vignette: float = 0.0,
                 seed: int = 0):
        self.base = base
        self.blur_px = blur_px
        self.noise_sigma = noise_sigma
        self.exposure_amp = exposure_amp
        self.vignette = vignette
        self.seed = seed
        self.timestamps = base.timestamps
        self.poses = base.poses
        h, w = base.height, base.width
        yy, xx = np.mgrid[0:h, 0:w]
        r2 = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2) / 2.0
        self._vig = (1.0 - vignette * r2).astype(np.float32)

    def __len__(self):
        return len(self.base)

    def _blur_kernel(self, i: int):
        if self.blur_px < 1.0 or i == 0:
            return None
        # dominant translation direction projected to the image plane
        R0, t0 = self.base.poses[i - 1]
        R1, t1 = self.base.poses[i]
        d = (-R1.T @ t1) - (-R0.T @ t0)
        dc = R1 @ d  # camera-frame motion
        v = np.array([dc[0], dc[1]])
        n = np.linalg.norm(v)
        v = v / n if n > 1e-9 else np.array([1.0, 0.0])
        L = max(int(round(self.blur_px)), 1)
        k = np.zeros((L * 2 + 1, L * 2 + 1), np.float32)
        for s in np.linspace(-L, L, 2 * L + 1):
            x, y = int(round(L + s * v[0])), int(round(L + s * v[1]))
            k[y, x] += 1.0
        return k / k.sum()

    def get(self, i: int):
        img, ts, pose = self.base.get(i)
        out = img.astype(np.float32)
        k = self._blur_kernel(i)
        if k is not None:
            out = require_cv2().filter2D(out, -1, k)
        if self.vignette > 0:
            out = out * self._vig
        if self.exposure_amp > 0:
            gain = 1.0 + self.exposure_amp * np.sin(2 * np.pi * i / 60.0)
            out = out * gain
        if self.noise_sigma > 0:
            rng = np.random.default_rng(self.seed * 100003 + i)
            out = out + rng.normal(0.0, self.noise_sigma, out.shape)
        return np.clip(out, 0, 255).astype(np.uint8), ts, pose


def write_tum_sequence(path: str, seq, n: int | None = None):
    """Materialize a rendered sequence as a TUM RGB-D directory
    (rgb.txt + rgb/*.png) so the TumDataset/eval --tum path is exercised
    end-to-end without real data. Returns the ground-truth pose dict."""
    cv2 = require_cv2()
    os.makedirs(os.path.join(path, "rgb"), exist_ok=True)
    gt = {}
    lines = ["# color images", "# file: synthetic", "# timestamp filename"]
    for i in range(n or len(seq)):
        img, ts, pose = seq.get(i)
        rel = f"rgb/{ts:.6f}.png"
        cv2.imwrite(os.path.join(path, rel), img)
        lines.append(f"{ts:.6f} {rel}")
        gt[round(float(ts), 6)] = pose
    with open(os.path.join(path, "rgb.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return gt
