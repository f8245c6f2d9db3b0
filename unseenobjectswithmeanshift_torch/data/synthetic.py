"""Synthetic tabletop scenes: the host-side scene sampler and renderer.

The port's own copy of ``unseenobjectswithmeanshift_tpu.data.synthetic``
(:63-559): ``sample_scene_params`` draws one scene (a table plane pitched
30-55 deg about 1.0-1.4 m away, 3 to max_objects spheres, boxes and capped
cylinders resting on it, their albedos, the table's mottle and the light)
as packed fixed-shape float32 arrays, from a ``numpy.random.RandomState``,
in the JAX package's draw order, so that one seed gives the same scene in
both packages. ``data/synthetic_device.py`` renders the scenes on the card;
``render_scene_numpy`` renders one on the host (closest hit of analytic
rays, as the JAX package's numpy renderer does, its table mottle upsampled
by ``image_ops.resize_cubic_f32``, OpenCV's INTER_CUBIC without OpenCV),
and ``SyntheticTabletopDataset`` serves the host-rendered scenes as
``TableTopObject`` samples (the ``synthetic_tabletop`` dataset). The TOD
camera's intrinsics come from ``fov_intrinsics`` (the JAX package's
``data.datasets.fov_intrinsics``, computed the same way).

The scenes stand in for the Tabletop Object Dataset (ShapeNet solids on a
table, exact labels and depth), which is not in the repository: a
learning-capability source, not an accuracy-parity one.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import augmentation as aug
from . import image_ops
from .datasets import TableTopObject, compute_xyz, normalize_bgr, remap_labels

KIND_NONE, KIND_SPHERE, KIND_BOX, KIND_CYLINDER = 0, 1, 2, 3

MOTTLE_HW = (12, 16)   # low-frequency table-texture grid, upsampled bicubic


def fov_intrinsics(width=640, height=480, fov_deg=45.0, near=0.01):
    """The TOD synthetic camera's intrinsics (ref: tabletop_object.py:57-93)."""
    aspect = width / height
    e = 1.0 / np.tan(np.radians(fov_deg / 2.0))
    t = near / e
    r = t * aspect
    alpha = width / (2 * r)
    focal = near * alpha
    return dict(fx=focal, fy=focal, x_offset=width / 2.0, y_offset=height / 2.0)


def _rot_about(u, ang):
    """Rodrigues rotation matrix about unit axis u."""
    c, s = np.cos(ang), np.sin(ang)
    ux, uy, uz = u
    K = np.array([[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]], np.float32)
    return (c * np.eye(3, dtype=np.float32) + s * K
            + (1 - c) * np.outer(u, u)).astype(np.float32)


def sample_scene_params(rng, intr, max_objects=9, min_objects=3,
                        height=480, width=640,
                        dist_range=(1.0, 1.4), max_slots=None,
                        p_stack=0.0, p_composite=0.0,
                        touching=False) -> Dict[str, np.ndarray]:
    """Sample one scene as packed fixed-shape float32 arrays.

    Returns a dict with:
      plane_p0 [3], plane_n [3] (unit), kinds [M] int32 (KIND_*),
      centers [M,3] (sphere center / box center / cylinder base),
      rots [M,3,3] (box->camera; identity otherwise),
      axes [M,3] (cylinder axis = plane normal),
      dims [M,3] (sphere (r,0,0) / box half-extents / cylinder (r,h,0)),
      ids [M] int32 (instance id per primitive slot; composites span
      several slots sharing one id), albedos [M,3] in [0,1] RGB,
      table_albedo [3], mottle [12,16], light [3] (unit, FROM the light).
    Padded slots have kind KIND_NONE / id 0.

    OCID-statistics knobs (all off by default - the default draw sequence is
    BIT-IDENTICAL to the round-4 streams, keeping old checkpoints' held-out
    evaluation stable):
      p_stack:      probability a new object is placed ON TOP of an earlier
                    box/cylinder (objects resting on boxes - OCID clutter)
      p_composite:  probability of a CONCAVE multi-primitive object (L-block
                    of 2 boxes, or a 3-part arch) sharing one instance id
      touching:     per-pair spacing shrinks to ~sum of footprint radii
                    (adjacent/abutting objects) instead of a fixed 8.5 cm
      max_slots:    primitive slots M (>= max_objects; composites use 2-3)
    OCID scenes hold up to 20 instances (ref scan:
    lib/datasets/get_max_num_object.py); data/synthetic_device.py's loader
    expose these via scene_style='ocid'.
    """
    M = max_slots or max_objects
    pitch = rng.uniform(np.radians(30), np.radians(55))
    dist = rng.uniform(*dist_range)   # (0.35, 0.7) emulates the zoomed-in
    # framing of stage-2 RoI crops (ref: crop_rois resizes a +25%-padded
    # tight box to 224^2, test_dataset.py:62-112)
    n = np.array([0.0, -np.cos(pitch), -np.sin(pitch)], np.float32)
    roll = rng.uniform(-0.12, 0.12)
    n = _rot_about(np.array([0, 0, 1], np.float32), roll) @ n
    n /= np.linalg.norm(n)
    p0 = np.array([0.0, 0.15 * dist, dist], np.float32)

    fx, fy = intr["fx"], intr["fy"]
    px, py = intr["x_offset"], intr["y_offset"]

    kinds = np.zeros(M, np.int32)
    centers = np.zeros((M, 3), np.float32)
    rots = np.tile(np.eye(3, dtype=np.float32), (M, 1, 1))
    axes = np.tile(n, (M, 1)).astype(np.float32)
    dims = np.zeros((M, 3), np.float32)
    albedos = np.zeros((M, 3), np.float32)
    ids = np.zeros(M, np.int32)

    u1 = np.cross(n, [0.0, 0.0, 1.0]); u1 /= np.linalg.norm(u1)
    u2 = np.cross(n, u1)
    Rw = np.stack([u1, u2, n], axis=1).astype(np.float32)
    ez = np.array([0, 0, 1], np.float32)

    def ground_foot():
        """Shoot a ray through a random central pixel -> in-view plane point."""
        u = rng.uniform(0.12 * width, 0.88 * width)
        v = rng.uniform(0.35 * height, 0.92 * height)
        d = np.array([(u - px) / fx, (v - py) / fy, 1.0], np.float32)
        dn = float(d @ n)
        if abs(dn) < 1e-6:
            return None
        t = float(p0 @ n) / dn
        if t <= 0:
            return None
        return (t * d).astype(np.float32)

    k = int(rng.randint(min_objects, max_objects + 1))
    ocid_mode = bool(p_stack or p_composite or touching)

    if not ocid_mode:
        # ------ legacy placement (round-4 streams; draw order preserved) --
        feet, placed, tries = [], 0, 0
        while placed < k and tries < 300:
            tries += 1
            foot = ground_foot()
            if foot is None:
                continue
            if any(np.sum((foot - f) ** 2) < 0.085 ** 2 for f in feet):
                continue
            kind = rng.choice([KIND_SPHERE, KIND_BOX, KIND_CYLINDER])
            albedos[placed] = rng.uniform(0.15, 0.95, size=3)
            kinds[placed] = kind
            ids[placed] = placed + 1
            if kind == KIND_SPHERE:
                r = rng.uniform(0.03, 0.07)
                centers[placed] = foot + r * n
                dims[placed] = (r, 0, 0)
            elif kind == KIND_CYLINDER:
                r = rng.uniform(0.025, 0.055)
                h = rng.uniform(0.06, 0.18)
                centers[placed] = foot
                dims[placed] = (r, h, 0)
            else:
                half = rng.uniform([0.025, 0.025, 0.03],
                                   [0.065, 0.065, 0.10]).astype(np.float32)
                yaw = rng.uniform(0, np.pi)
                rots[placed] = Rw @ _rot_about(ez, yaw)
                centers[placed] = foot + half[2] * n
                dims[placed] = half
            feet.append(foot)
            placed += 1
    else:
        # ------ OCID-statistics placement: clutter, stacking, composites --
        feet = []          # (foot, footprint_radius)
        supports = []      # (top_center, ax0, ax1, ex, ey): stackable tops
        inst, slot, tries = 0, 0, 0
        while inst < k and slot < M - 2 and tries < 500:
            tries += 1
            stacked = supports and rng.rand() < p_stack
            if stacked:
                top, ax0, ax1, ex, ey = supports[rng.randint(len(supports))]
                foot = (top + ax0 * ex * rng.uniform(-0.5, 0.5)
                        + ax1 * ey * rng.uniform(-0.5, 0.5)).astype(np.float32)
            else:
                foot = ground_foot()
                if foot is None:
                    continue
            composite = (not stacked) and rng.rand() < p_composite
            albedo = rng.uniform(0.15, 0.95, size=3)
            iid = inst + 1

            if composite and rng.rand() < 0.5:
                # L-block: base slab + upright block at one end (concave)
                hx = rng.uniform(0.04, 0.08)
                hy = rng.uniform(0.025, 0.05)
                hz = rng.uniform(0.02, 0.04)
                hz2 = rng.uniform(0.05, 0.12)
                yaw = rng.uniform(0, np.pi)
                R = Rw @ _rot_about(ez, yaw)
                rad = float(np.hypot(hx, hy))
                if not _spaced(foot, rad, feet, touching):
                    continue
                for c, half in ((foot + hz * n, (hx, hy, hz)),
                                (foot + R[:, 0] * (hx - 0.35 * hx) + hz2 * n,
                                 (0.35 * hx, hy, hz2))):
                    kinds[slot] = KIND_BOX
                    centers[slot] = c
                    rots[slot] = R
                    dims[slot] = half
                    albedos[slot] = albedo
                    ids[slot] = iid
                    slot += 1
            elif composite:
                # arch: two pillars + lid (concave gap underneath)
                gap = rng.uniform(0.02, 0.045)
                pw = rng.uniform(0.012, 0.022)
                pd = rng.uniform(0.015, 0.03)
                ph = rng.uniform(0.04, 0.09)
                lt = rng.uniform(0.008, 0.016)
                yaw = rng.uniform(0, np.pi)
                R = Rw @ _rot_about(ez, yaw)
                span = gap + 2 * pw
                rad = float(np.hypot(span + 0.01, pd))
                if not _spaced(foot, rad, feet, touching):
                    continue
                for c, half in (
                        (foot - R[:, 0] * (gap + pw) + ph * n, (pw, pd, ph)),
                        (foot + R[:, 0] * (gap + pw) + ph * n, (pw, pd, ph)),
                        (foot + (2 * ph + lt) * n, (span + 0.01, pd, lt))):
                    kinds[slot] = KIND_BOX
                    centers[slot] = c
                    rots[slot] = R
                    dims[slot] = half
                    albedos[slot] = albedo
                    ids[slot] = iid
                    slot += 1
            else:
                kind = rng.choice([KIND_SPHERE, KIND_BOX, KIND_CYLINDER])
                if kind == KIND_SPHERE:
                    r = rng.uniform(0.03, 0.07)
                    if not _spaced(foot, r, feet, touching):
                        continue
                    kinds[slot] = KIND_SPHERE
                    centers[slot] = foot + r * n
                    dims[slot] = (r, 0, 0)
                    rad = r
                elif kind == KIND_CYLINDER:
                    r = rng.uniform(0.025, 0.055)
                    h = rng.uniform(0.06, 0.18)
                    if not _spaced(foot, r, feet, touching):
                        continue
                    kinds[slot] = KIND_CYLINDER
                    centers[slot] = foot
                    dims[slot] = (r, h, 0)
                    rad = r
                    if not stacked:
                        supports.append((foot + h * n, u1, u2,
                                         0.8 * r, 0.8 * r))
                else:
                    half = rng.uniform([0.025, 0.025, 0.03],
                                       [0.065, 0.065, 0.10]).astype(np.float32)
                    yaw = rng.uniform(0, np.pi)
                    R = Rw @ _rot_about(ez, yaw)
                    rad = float(np.hypot(half[0], half[1]))
                    if not _spaced(foot, rad, feet, touching):
                        continue
                    kinds[slot] = KIND_BOX
                    centers[slot] = foot + half[2] * n
                    rots[slot] = R
                    dims[slot] = half
                    if not stacked:
                        supports.append((foot + 2 * half[2] * n,
                                         R[:, 0], R[:, 1],
                                         0.8 * half[0], 0.8 * half[1]))
                albedos[slot] = albedo
                ids[slot] = iid
                slot += 1
            feet.append((foot, rad))
            inst += 1

    light = np.array([rng.uniform(-0.3, 0.3), -1.0,
                      rng.uniform(-0.5, 0.2)], np.float32)
    light /= np.linalg.norm(light)
    return dict(
        plane_p0=p0, plane_n=n, kinds=kinds, centers=centers, rots=rots,
        axes=axes, dims=dims, ids=ids, albedos=albedos,
        table_albedo=rng.uniform(0.35, 0.75, size=3).astype(np.float32),
        mottle=rng.rand(*MOTTLE_HW).astype(np.float32),
        light=light)


def _spaced(foot, rad, feet, touching):
    """Rejection predicate: 3D foot spacing. touching mode allows abutting
    objects (spacing ~ sum of footprint radii); legacy-style entries in
    `feet` are (foot, radius) tuples here (OCID mode only)."""
    for f, r in feet:
        dmin = 0.9 * (rad + r) if touching else 0.085
        if float(np.sum((foot - f) ** 2)) < dmin * dmin:
            return False
    return True



# ---------------------------------------------------------------------------
# the host renderer (JAX data/synthetic.py:314-452)


def _ray_dirs(H, W, intr):
    cols, rows = np.meshgrid(np.arange(W, dtype=np.float32),
                             np.arange(H, dtype=np.float32))
    d = np.stack([(cols - intr["x_offset"]) / intr["fx"],
                  (rows - intr["y_offset"]) / intr["fy"],
                  np.ones_like(cols)], axis=-1)          # [H, W, 3], dz = 1
    return d.reshape(-1, 3)


def _intersect_plane(d, p0, n):
    """Rays from the origin: t = (p0.n) / (d.n); t <= 0 -> no hit."""
    dn = d @ n
    t = np.where(np.abs(dn) > 1e-9, (p0 @ n) / np.where(dn == 0, 1.0, dn), np.inf)
    return np.where(t > 1e-6, t, np.inf)


def _intersect_sphere(d, c, r):
    """|t d - c|^2 = r^2 with |d| != 1: a t^2 - 2 t d.c + |c|^2 - r^2 = 0."""
    a = np.sum(d * d, axis=1)
    b = d @ c
    cc = float(c @ c - r * r)
    disc = b * b - a * cc
    ok = disc > 0
    sq = np.sqrt(np.where(ok, disc, 0.0))
    t = (b - sq) / a                            # the nearest root
    return np.where(ok & (t > 1e-6), t, np.inf)


def _intersect_box(d, center, R, half):
    """Oriented box: the slab method in the box frame (R: box -> camera)."""
    o = -center @ R                             # R^T @ (0 - center)
    dd = d @ R                                  # [N, 3] directions in the box frame
    safe = np.where(np.abs(dd) < 1e-12, 1e-12, dd)
    t1 = (-half - o) / safe
    t2 = (half - o) / safe
    tmin = np.minimum(t1, t2).max(axis=1)
    tmax = np.maximum(t1, t2).min(axis=1)
    hit = (tmax >= tmin) & (tmax > 1e-6)
    t = np.where(tmin > 1e-6, tmin, tmax)       # rays from inside the box exit forward
    return np.where(hit, t, np.inf)


def _intersect_cylinder(d, base, axis, r, h):
    """Finite capped cylinder: base point, unit axis, radius, height."""
    d_par = (d @ axis)[:, None] * axis
    d_ort = d - d_par
    o = -base
    o_par = float(o @ axis) * axis
    o_ort = o - o_par
    a = np.sum(d_ort * d_ort, axis=1)
    b = d_ort @ o_ort
    c = float(o_ort @ o_ort) - r * r
    disc = b * b - a * c
    ok = (disc > 0) & (a > 1e-12)
    sq = np.sqrt(np.where(ok, disc, 0.0))
    sa = np.where(a > 1e-12, a, 1.0)
    t_side = np.where(ok, (-b - sq) / sa, np.inf)
    with np.errstate(invalid="ignore"):
        z_hit = np.where(np.isfinite(t_side), (t_side * (d @ axis)) - float(base @ axis), np.inf)
    t_side = np.where((t_side > 1e-6) & (z_hit >= 0) & (z_hit <= h), t_side, np.inf)
    # the caps: planes at base and base + h * axis, inside the radius
    t_caps = np.full_like(t_side, np.inf)
    dn = d @ axis
    for p0c in (base, base + h * axis):
        tc = np.where(np.abs(dn) > 1e-9, float(p0c @ axis) / np.where(dn == 0, 1, dn), np.inf)
        with np.errstate(invalid="ignore"):
            hitp = np.where(np.isfinite(tc)[:, None], tc[:, None] * d, 0.0) - p0c
        inside = np.sum(hitp * hitp, axis=1) <= r * r
        t_caps = np.minimum(t_caps, np.where((tc > 1e-6) & np.isfinite(tc) & inside, tc, np.inf))
    return np.minimum(t_side, t_caps)


def render_scene_numpy(params, H, W, intr, backend="native"):
    """Closest-hit render of packed params.

    Returns (rgb float32 [H, W, 3] in [0, 1], depth_m float32 [H, W] (0 where
    no hit), label int32 [H, W]: 0 = plane / background, else params['ids']
    [slot], the instance id (composites span several slots of one id)).
    ``backend`` picks the mottle's cubic upsampling (native or its twin).
    """
    d = _ray_dirs(H, W, intr)
    N = d.shape[0]
    n = params["plane_n"]
    t_best = _intersect_plane(d, params["plane_p0"], n)
    ids = np.zeros(N, np.int32)
    normals = np.broadcast_to(n, (N, 3)).copy()
    mottle = image_ops.resize_cubic_f32(params["mottle"], H, W, backend=backend)
    albedos = (params["table_albedo"] * (0.8 + 0.4 * mottle.reshape(-1, 1))).astype(np.float32)

    with np.errstate(invalid="ignore"):
        for i in range(len(params["kinds"])):
            kind = int(params["kinds"][i])
            if kind == KIND_NONE:
                continue
            c = params["centers"][i]
            if kind == KIND_SPHERE:
                r = float(params["dims"][i][0])
                t = _intersect_sphere(d, c, r)
                p = np.where(np.isfinite(t)[:, None], t[:, None] * d, 0.0)
                nm = p - c
            elif kind == KIND_CYLINDER:
                axis = params["axes"][i]
                r, h = float(params["dims"][i][0]), float(params["dims"][i][1])
                t = _intersect_cylinder(d, c, axis, r, h)
                p = np.where(np.isfinite(t)[:, None], t[:, None] * d, 0.0)
                z = (p - c) @ axis
                side = p - c - z[:, None] * axis
                nm = np.where((z > 1e-4)[:, None] & (z < h - 1e-4)[:, None],
                              side, np.sign(z - h / 2)[:, None] * axis)
            else:
                R = params["rots"][i]
                half = params["dims"][i]
                t = _intersect_box(d, c, R, half)
                p = np.where(np.isfinite(t)[:, None], t[:, None] * d, 0.0)
                local = (p - c) @ R
                ax = np.argmax(np.abs(local) / half, axis=1)
                nm = np.sign(local[np.arange(N), ax] + 1e-30)[:, None] * R.T[ax]
            hit = t < t_best
            t_best = np.where(hit, t, t_best)
            ids = np.where(hit, int(params["ids"][i]), ids)
            normals = np.where(hit[:, None], nm, normals)
            albedos = np.where(hit[:, None], params["albedos"][i], albedos)

    depth = np.where(np.isfinite(t_best), t_best, 0.0)   # dz = 1 -> t is the z depth
    nn = normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-9)
    lam = np.abs(nn @ params["light"])
    shade = 0.35 + 0.65 * lam
    rgb = np.clip(albedos * shade[:, None], 0, 1)
    return (rgb.reshape(H, W, 3).astype(np.float32), depth.reshape(H, W).astype(np.float32),
            ids.reshape(H, W))


class SyntheticTabletopDataset(TableTopObject):
    """TableTopObject's samples from scenes rendered on the host.

    The same sample dict ({image, xyz, label, file_name}) and the same
    augmentation / SYN_CROP / pixel-sampling machinery (inherited); only the
    source differs. Samples are deterministic in (seed, image_set, idx), and
    'train' and 'test' index disjoint scene streams. The host ray-casts a
    480x640 scene in about a second; training renders on the card instead
    (``data/synthetic_device.SyntheticDeviceLoader``).
    """

    def __init__(self, num_scenes=20000, image_set="train", input_type="RGBD",
                 height=480, width=640, max_objects=9, min_objects=3,
                 use_augmentation=True, syn_crop=False, crop_size=224,
                 min_padding=0.5, max_padding=1.0,
                 sampling=False, sampling_num=1000, chromatic=True,
                 add_noise=True, seed: Optional[int] = 0, scene_style="r4"):
        self.num_scenes = int(num_scenes)
        self.image_set = image_set
        self.input_type = input_type
        self.H, self.W = int(height), int(width)
        self.max_objects = max_objects
        self.min_objects = min_objects
        # 'ocid' pushes the scene statistics toward OCID clutter
        # (sample_scene_params); 'r4' keeps the round-4 streams
        self.style = dict(p_stack=0.0, p_composite=0.0, touching=False, max_slots=None)
        if scene_style == "ocid":
            self.style = dict(p_stack=0.3, p_composite=0.25, touching=True,
                              max_slots=max(20, max_objects + 6))
            self.max_objects = max(max_objects, 14)
            self.min_objects = max(min_objects, 5)
        elif scene_style != "r4":
            raise ValueError(f"unknown scene_style {scene_style!r}")
        self.use_augmentation = use_augmentation
        self.syn_crop = syn_crop
        self.crop_size = crop_size
        self.min_padding = min_padding
        self.max_padding = max_padding
        self.sampling = sampling
        self.sampling_num = sampling_num
        self.chromatic = chromatic
        self.add_noise = add_noise
        self.base_seed = 0 if seed is None else int(seed)
        self.split_salt = {"train": 0, "test": 1 << 20, "all": 0}[image_set]   # disjoint streams
        self.rng = np.random.RandomState(self.base_seed)  # the augmentations' draws
        self.intrinsics = fov_intrinsics(self.W, self.H)

    def __len__(self):
        return self.num_scenes

    def scene_rng(self, idx):
        return np.random.RandomState(
            (self.base_seed * 1_000_003 + self.split_salt + int(idx)) % (2 ** 31 - 1))

    def scene_params(self, idx):
        return sample_scene_params(self.scene_rng(idx), self.intrinsics,
                                   max_objects=self.max_objects, min_objects=self.min_objects,
                                   height=self.H, width=self.W, **self.style)

    def __getitem__(self, idx):
        params = self.scene_params(idx)
        rgb, depth, label = render_scene_numpy(params, self.H, self.W, self.intrinsics)
        im = (rgb[..., ::-1] * 255).astype(np.uint8)     # BGR uint8
        label = remap_labels(label)

        xyz = None
        if self.input_type in ("DEPTH", "RGBD"):
            if self.use_augmentation:
                depth = aug.add_noise_to_depth(depth, rng=self.rng)
                depth = aug.dropout_random_ellipses(depth, rng=self.rng)
            i = self.intrinsics
            xyz = compute_xyz(depth, i["fx"], i["fy"], i["x_offset"], i["y_offset"])
            if self.use_augmentation:
                xyz = aug.add_noise_to_xyz(np.asarray(xyz), depth, rng=self.rng)
            xyz = np.asarray(xyz, np.float32)

        if self.syn_crop:
            im, label, xyz = self.pad_crop_resize(im, label, xyz)
            label = remap_labels(label)

        sample_label = label
        if self.sampling:
            sample_label = self.sample_pixels(label, self.sampling_num)

        if self.chromatic and self.rng.rand(1) > 0.1:
            im = aug.chromatic_transform(im, rng=self.rng)
        if self.add_noise and self.rng.rand(1) > 0.1:
            im = aug.add_noise(im, rng=self.rng)

        return {"image": normalize_bgr(im), "xyz": xyz,
                "label": sample_label.astype(np.int32),
                "file_name": f"synthetic/{self.image_set}/{idx:07d}"}
