"""Synthetic tabletop scenes: the host-side scene sampler.

The port's own copy of ``unseenobjectswithmeanshift_tpu.data.synthetic``'s
sampler (:63-313): ``sample_scene_params`` draws one scene (a table plane
pitched 30-55 deg about 1.0-1.4 m away, 3 to max_objects spheres, boxes and
capped cylinders resting on it, their albedos, the table's mottle and the
light) as packed fixed-shape float32 arrays, from a
``numpy.random.RandomState``, in the JAX package's draw order, so that one
seed gives the same scene in both packages. ``data/synthetic_device.py``
renders the scenes on the card. The TOD camera's intrinsics come from
``fov_intrinsics`` (the JAX package's ``data.datasets.fov_intrinsics``,
computed the same way).

The scenes stand in for the Tabletop Object Dataset (ShapeNet solids on a
table, exact labels and depth), which is not in the repository: a
learning-capability source, not an accuracy-parity one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

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
