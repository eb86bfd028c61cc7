"""Object library: fixed-size sphere-compound geometry for every graspable object.

The port's own numpy copy of deep_rl_grasping_tpu/sim/objects.py: same seed
(20260816), same generator calls in the same order, same 700/150/150 split,
so every array matches the JAX package's library bit for bit.

TPU-native replacement for the reference's URDF/OBJ assets
(reference: models/wooden_blocks/*.urdf and the pybullet_data `random_urdfs`
000-999 dataset, sampled in manipulation_main/simulation/base_scene.py:22-43).

Instead of parsing meshes per episode reset (the reference reloads URDFs from
disk every reset, SURVEY.md §3.4), geometry lives in dense arrays indexed by an
integer object type:

  centers  (T, S, 3)  sphere centers, COM frame, principal axes
  radii    (T, S)     sphere radii (0 padding => masked out)
  mass     (T,)       total mass
  inv_inertia (T, 3)  inverse principal inertia diagonal
  color    (T, 3)     base color for the renderer

T = 6 wooden blocks + 1000 procedurally generated "random" objects matching
the random_urdfs scale statistics (2-9 cm, 20-100 g). The 000-999 ids keep the
reference's dataset split: train 0-699, validate 700-849, test 850-999
(base_scene.py:32-43). Sphere compounds make both collision (sphere vs
plane/box/sphere) and rendering (closed-form ray-sphere) branch-free and
MXU/VPU friendly.
"""

from __future__ import annotations

import functools

import numpy as np

WOODEN_BLOCK_NAMES = [
    "circular_segment",
    "cube",
    "cuboid0",
    "cuboid1",
    "cylinder",
    "triangle",
]
NUM_WOODEN = len(WOODEN_BLOCK_NAMES)
NUM_RANDOM = 1000
WOOD_DENSITY = 740.0  # kg/m^3, matches 30 mm cube @ 0.020 kg (cube.urdf)
# Exact masses from the reference URDFs (models/wooden_blocks/<name>.urdf
# <mass value>): sphere-compound volume underestimates boxes by ~2x
# (sphere packing), so masses are pinned to the reference values rather
# than derived from sphere volume (validated by scripts_dev/object_stats.py).
WOODEN_BLOCK_MASSES = {
    "circular_segment": 0.014,
    "cube": 0.020,
    "cuboid0": 0.035,
    "cuboid1": 0.025,
    "cylinder": 0.025,
    "triangle": 0.020,
}


def _box_spheres(half_extents, s):
    """Fill a box with up to `s` overlapping spheres along its longest axis.

    Sphere spacing is kept <= ~1.1 r so inter-sphere "waists" stay shallow:
    the gripper's finger-stall grasp detection (robot.py:295-297) requires
    any pinchable cross-section to be wider than the 5 mm width tolerance.
    """
    hx, hy, hz = half_extents
    r = min(hx, hy, hz)
    long_axis = int(np.argmax(half_extents))
    L = half_extents[long_axis]
    span = 2.0 * (L - r)
    n = max(1, min(s, int(np.ceil(span / (1.1 * r))) + 1))
    centers = np.zeros((n, 3))
    if n > 1:
        centers[:, long_axis] = np.linspace(-(L - r), L - r, n)
    return centers, np.full(n, r)


def _block_geometry(name, s):
    """Sphere approximations of the six wooden blocks (sizes from the shipped
    meshes' bounding boxes; see models/wooden_blocks/meshes)."""
    if name == "cube":
        return _box_spheres([0.015, 0.015, 0.015], s)
    if name == "cuboid0":
        return _box_spheres([0.015, 0.03, 0.015], s)
    if name == "cuboid1":
        return _box_spheres([0.0075, 0.045, 0.015], s)
    if name == "cylinder":
        return _box_spheres([0.03, 0.015, 0.015], s)
    if name == "circular_segment":
        c, r = _box_spheres([0.015, 0.025, 0.010], s)
        return c, r
    if name == "triangle":
        # wedge: two rows of shrinking spheres
        c = np.array([[0.0, -0.013, -0.004], [0.0, 0.000, -0.004], [0.0, 0.013, -0.004], [0.0, 0.0, 0.008]])
        r = np.array([0.011, 0.011, 0.011, 0.009])
        return c, r
    raise ValueError(name)


def _random_object_geometry(rng, s):
    """Procedural stand-in for one `random_urdfs` object.

    The real dataset (gitignored in the reference, sourced from pybullet_data;
    sampled at base_scene.py:32-43) is a set of small scanned household
    objects ~3-10 cm across spanning flat / elongated / concave / blocky
    grasp affordances. Since the meshes are unavailable in this image, each
    id draws one of five sphere-compound shape classes covering that
    affordance range (VERDICT r3 #10; fidelity delta documented in
    docs/OBJECT_LIBRARY.md):

      blob   — overlapping chain + satellite spheres (round-3 geometry)
      rod    — thin capsule-like chain (elongated side grasps)
      plate  — flat 2 x n grid (low, wide footprint; top pinches only)
      bent   — L-shaped chain (concave inner corner)
      block  — 2x2(x2) cluster (box-like, any-side grasp)

    All classes keep adjacent-sphere spacing <= ~1.1 r so inter-sphere
    "waists" stay above the 5 mm finger-stall grasp-detection width
    (robot.py:295-297), and every pinchable cross-section (2r = 16-32 mm)
    fits the 50 mm gripper opening with >=3x margin over the 5 mm
    empty-grip tolerance even under partial solver penetration.
    """
    shape = rng.choice(
        ["blob", "rod", "plate", "bent", "block"],
        p=[0.3, 0.2, 0.2, 0.15, 0.15],
    )
    if shape == "rod":
        n = min(s, int(rng.integers(4, 7)))
        r = rng.uniform(0.008, 0.012)
        t = np.linspace(-0.5, 0.5, n)
        centers = np.zeros((n, 3))
        centers[:, 0] = t * (1.0 * r * (n - 1))
        radii = np.full(n, r) * rng.uniform(0.9, 1.1, n)
        return centers, radii, shape
    if shape == "plate":
        cols = min(s // 2, 4)
        r = rng.uniform(0.009, 0.013)
        xs = (np.arange(cols) - (cols - 1) / 2.0) * (1.05 * r)
        ys = np.array([-0.525 * r, 0.525 * r])
        gx, gy = np.meshgrid(xs, ys)
        centers = np.stack(
            [gx.ravel(), gy.ravel(), np.zeros(2 * cols)], axis=1
        )
        radii = np.full(2 * cols, r)
        return centers, radii, shape
    if shape == "bent":
        n = min(s, 6)
        n_a = n // 2 + 1
        r = rng.uniform(0.009, 0.013)
        step = 1.0 * r
        arm_a = np.zeros((n_a, 3))
        arm_a[:, 0] = np.arange(n_a) * step
        arm_b = np.zeros((n - n_a, 3))
        arm_b[:, 1] = (1 + np.arange(n - n_a)) * step
        centers = np.concatenate([arm_a, arm_b], 0)
        centers -= centers.mean(0)
        radii = np.full(n, r) * rng.uniform(0.9, 1.1, n)
        return centers, radii, shape
    if shape == "block":
        r = rng.uniform(0.008, 0.013)
        two_layer = s >= 8 and rng.random() < 0.5
        zs = [-0.5 * r, 0.5 * r] if two_layer else [0.0]
        pts = []
        for z in zs:
            for x in (-0.55 * r, 0.55 * r):
                for y in (-0.55 * r, 0.55 * r):
                    pts.append([x, y, z])
        centers = np.asarray(pts)
        radii = np.full(len(pts), r)
        return centers, radii, shape

    # blob (round-3 geometry, unchanged)
    n = int(rng.integers(3, s + 1))
    base_r = rng.uniform(0.008, 0.016)
    length = rng.uniform(0.015, 0.045)
    axis = rng.normal(size=3)
    # Bias toward lying shapes (graspable side profile)
    axis[2] *= 0.3
    axis /= np.linalg.norm(axis) + 1e-9
    n_core = max(2, n - int(rng.integers(0, 2)))
    # Keep spheres overlapping (spacing <= 0.8 base_r): deep waists between
    # spheres would let the fingers pinch below the 5 mm grasp-detection
    # width (robot.py:295-297) while still wedging the object.
    length = min(length, 0.8 * base_r * (n_core - 1))
    t = np.linspace(-0.5, 0.5, n_core)
    centers = np.outer(t, axis) * length
    radii = base_r * rng.uniform(0.75, 1.25, size=n_core)
    # satellites
    n_sat = n - n_core
    if n_sat > 0:
        host = rng.integers(0, n_core, size=n_sat)
        offs = rng.normal(size=(n_sat, 3))
        offs /= np.linalg.norm(offs, axis=1, keepdims=True) + 1e-9
        sat_r = base_r * rng.uniform(0.5, 0.9, size=n_sat)
        sat_c = centers[host] + offs * (radii[host] * 0.8)[:, None]
        centers = np.concatenate([centers, sat_c], 0)
        radii = np.concatenate([radii, sat_r], 0)
    return centers, radii, shape


def _coarse_fit(centers, radii, k):
    """Fit k enclosing spheres to a union-of-spheres compound.

    Volume-weighted k-means on the member centers (farthest-point init),
    each group covered by the tightest sphere around its members. Used as
    the object-object narrow-phase LOD: pad/static contacts keep the full
    S-sphere geometry (grasp fidelity lives there), while object-object
    pairs — measured at 57% of the fused solver kernel's cycles at
    S=8 (docs/KERNEL_BREAKDOWN.md) — only need coarse shape to keep
    clutter from interpenetrating. k=4 cuts the (NP,S,S,E) planes 4x.
    """
    n = len(radii)
    k = min(k, n)
    w = radii**3
    idx = [int(np.argmax(radii))]
    for _ in range(k - 1):
        d = np.min(
            [np.linalg.norm(centers - centers[i], axis=1) for i in idx],
            axis=0,
        )
        idx.append(int(np.argmax(d)))
    g = centers[idx].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(8):
        d = np.linalg.norm(centers[:, None, :] - g[None], axis=-1)
        assign = np.argmin(d, axis=1)
        for j in range(k):
            m = assign == j
            if m.any():
                g[j] = (w[m, None] * centers[m]).sum(0) / w[m].sum()
    R = np.zeros(k)
    for j in range(k):
        m = assign == j
        if m.any():
            R[j] = (np.linalg.norm(centers[m] - g[j], axis=1) + radii[m]).max()
    keep = R > 0
    return g[keep], R[keep]


def _compound_mass_inertia(centers, radii, density):
    """Mass, COM and principal inertia of a union-of-spheres (treated as
    disjoint solid spheres; overlap double-counting is acceptable for RL)."""
    vols = 4.0 / 3.0 * np.pi * radii**3
    masses = vols * density
    m = masses.sum()
    com = (masses[:, None] * centers).sum(0) / m
    c = centers - com
    I = np.zeros((3, 3))
    for ci, ri, mi in zip(c, radii, masses):
        I += 2.0 / 5.0 * mi * ri**2 * np.eye(3)
        I += mi * (np.dot(ci, ci) * np.eye(3) - np.outer(ci, ci))
    evals, evecs = np.linalg.eigh(I)
    # rotate centers into principal frame
    c_p = c @ evecs
    return m, com, evals, evecs, c_p


class ObjectLibrary:
    """Dense arrays of all object geometry; build once, ship to device."""

    def __init__(self, spheres_per_object=8, seed=20260816, oo_spheres=4):
        S = spheres_per_object
        SC = oo_spheres
        T = NUM_WOODEN + NUM_RANDOM
        self.num_types = T
        self.spheres_per_object = S
        centers = np.zeros((T, S, 3), np.float32)
        radii = np.zeros((T, S), np.float32)
        oo_centers = np.zeros((T, SC, 3), np.float32)
        oo_radii = np.zeros((T, SC), np.float32)
        mass = np.zeros(T, np.float32)
        inv_inertia = np.zeros((T, 3), np.float32)
        color = np.zeros((T, 3), np.float32)
        shape_class = np.empty(T, dtype=object)

        rng = np.random.default_rng(seed)
        for t in range(T):
            if t < NUM_WOODEN:
                c, r = _block_geometry(WOODEN_BLOCK_NAMES[t], S)
                shape_name = "wooden"
                density = WOOD_DENSITY
                col = np.array([0.1, 0.5, 0.8]) if t == 1 else rng.uniform(0.3, 0.9, 3)
            else:
                c, r, shape_name = _random_object_geometry(rng, S)
                density = rng.uniform(300.0, 900.0)
                col = rng.uniform(0.2, 0.95, 3)
            c = c[:S]
            r = r[:S]
            m, com, evals, evecs, c_p = _compound_mass_inertia(c, r, density)
            if t < NUM_WOODEN:
                # Rescale to the reference URDF mass, keeping the inertia
                # shape from the sphere distribution.
                m_ref = WOODEN_BLOCK_MASSES[WOODEN_BLOCK_NAMES[t]]
                evals = evals * (m_ref / m)
                m = m_ref
            n = len(r)
            centers[t, :n] = c_p
            radii[t, :n] = r
            gc, gr = _coarse_fit(c_p, r, SC)
            oo_centers[t, : len(gr)] = gc
            oo_radii[t, : len(gr)] = gr
            mass[t] = m
            inv_inertia[t] = 1.0 / np.maximum(evals, 1e-9)
            color[t] = col
            shape_class[t] = shape_name

        self.centers = centers
        self.radii = radii
        self.oo_centers = oo_centers
        self.oo_radii = oo_radii
        self.mass = mass
        self.inv_mass = (1.0 / np.maximum(mass, 1e-9)).astype(np.float32)
        self.inv_inertia = inv_inertia
        self.color = color
        # Max distance from COM to sphere surface: used for settled placement.
        self.bound_radius = (np.linalg.norm(centers, axis=-1) + radii).max(-1).astype(np.float32)
        # Affordance class per type id ("wooden" or one of the five random
        # classes) — per-class success breakdowns in eval probes.
        self.shape_class = shape_class.astype(str)

    # Dataset splits (reference base_scene.py:32-43); ids offset by NUM_WOODEN.
    def random_urdf_ids(self, test=False, validate=False):
        if validate:
            lo, hi = 700, 850
        elif test:
            lo, hi = 850, 1000
        else:
            lo, hi = 0, 700
        return np.arange(NUM_WOODEN + lo, NUM_WOODEN + hi)

    def wooden_block_ids(self):
        return np.arange(0, NUM_WOODEN)


@functools.lru_cache(maxsize=4)
def get_library(spheres_per_object=8, seed=20260816, oo_spheres=4):
    return ObjectLibrary(spheres_per_object, seed, oo_spheres)
