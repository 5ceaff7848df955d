"""Initial-condition distribution library.

Re-implements the 25 named generators of the reference's
``tools/presets.py:91-1390`` (``generate_distribution``) with the same
statistical recipes: exponential disks with soft truncation, the softened
enclosed-mass rotation curve, Plummer clusters, cosmic-web filaments, etc.
Initial-condition generation runs once on the host in float64 numpy (as in
the reference) — it is not a hot path; the state is then pushed to device.

Differences from the reference (deliberate):
  * A seedable ``numpy.random.Generator`` instead of the global legacy RNG,
    so recordings are reproducible.
  * The per-particle Python loops of the reference (e.g. the Plummer
    velocity sampler at ``tools/presets.py:500-516``) are vectorized.
"""

from __future__ import annotations

import numpy as np

# The 25 distribution names of the reference (tools/presets.py:30-50).
DISTRIBUTIONS = [
    "galaxy", "collision", "spiral", "ring", "shell", "cluster", "binary",
    "elliptical", "bar", "stream", "filament", "explosion", "disc", "vortex",
    "cube", "pleiades", "double_helix", "accretion_disk", "torus",
    "hourglass", "fibonacci", "triple", "rosette", "dyson", "sphere",
]


def compute_rotation_curve(r, masses, G, softening):
    """Circular-orbit speed for a softened self-gravitating disk.

    Same model as the reference (``tools/presets.py:52-88``): Plummer-like
    ``v_c = sqrt(G M_enc r^2 / (r^2 + eps^2)^1.5)`` on sorted enclosed mass
    with ``eps = 2*softening``, then an inner damping factor floored at 0.3.
    """
    order = np.argsort(r)
    sorted_r = r[order]
    m_enc = np.cumsum(masses[order])
    eps_sq = (2.0 * softening) ** 2
    r_sq = sorted_r ** 2
    v = np.sqrt(G * m_enc * r_sq / (r_sq + eps_sq) ** 1.5)
    inner_scale_sq = (2.0 * softening) ** 2
    v *= np.maximum(r_sq / (r_sq + inner_scale_sq), 0.3)
    out = np.empty_like(v)
    out[order] = v
    return out


def _sphere_dirs(rng, n):
    """Isotropic unit vectors, (sin t cos p, cos t, sin t sin p) convention."""
    phi = rng.uniform(0, 2 * np.pi, n)
    cos_t = rng.uniform(-1, 1, n)
    sin_t = np.sqrt(1 - cos_t ** 2)
    return np.stack([sin_t * np.cos(phi), cos_t, sin_t * np.sin(phi)], axis=1)


def _zero_com_velocity(velocities, masses):
    com_vel = np.sum(velocities * masses[:, None], axis=0) / np.sum(masses)
    return velocities - com_vel


def _exponential_disk(rng, n, R, G, scale_frac=0.3, soft_frac=0.03,
                      max_r_frac=1.0, height_frac=0.012, sigma_frac=0.12,
                      spin=1.0, masses=None):
    """Shared recipe of the galaxy/collision disks (presets.py:104-146)."""
    if masses is None:
        masses = np.ones(n)
    scale_length = R * scale_frac
    softening = R * soft_frac
    r = rng.exponential(scale_length, n)
    max_r = R * max_r_frac
    r = r * (1 - np.exp(-max_r / (r + 0.01)))
    r = np.maximum(r, R * 0.001)
    theta = rng.uniform(0, 2 * np.pi, n)
    disk_height = R * height_frac * (1 + (r / R) ** 0.5 * 0.3)
    pos = np.stack([r * np.cos(theta),
                    rng.normal(0, 1, n) * disk_height,
                    r * np.sin(theta)], axis=1)
    orbital = compute_rotation_curve(r, masses, G, softening)
    vel = np.zeros((n, 3))
    vel[:, 0] = -spin * orbital * np.sin(theta)
    vel[:, 2] = spin * orbital * np.cos(theta)
    radial_factor = r / (r + softening * 2)
    sigma = orbital * sigma_frac * radial_factor + np.sqrt(G * n * 0.00005)
    vel[:, 0] += rng.normal(0, 1, n) * sigma
    vel[:, 2] += rng.normal(0, 1, n) * sigma
    vel[:, 1] = rng.normal(0, 1, n) * (sigma * 0.25)
    return pos, vel, r, theta


def generate_distribution(distribution, n, R, G, seed=None):
    """Generate initial conditions.

    Args:
      distribution: one of :data:`DISTRIBUTIONS`.
      n: body count.  R: spawn radius.  G: gravitational constant.
      seed: optional RNG seed (the reference uses the unseeded global RNG).

    Returns:
      (positions (n,3) f64, velocities (n,3) f64, masses (n,) f64)
    """
    rng = np.random.default_rng(seed)
    positions = np.zeros((n, 3))
    velocities = np.zeros((n, 3))
    masses = np.ones(n)

    if distribution == "galaxy":
        pos, vel, _, _ = _exponential_disk(rng, n, R, G)
        positions, velocities = pos, _zero_com_velocity(vel, masses)

    elif distribution == "collision":
        # Two compact counter-spinning disks on a slightly-bound approach
        # (presets.py:148-232).
        half = n // 2
        n2 = n - half
        separation = (R * 0.5) * 3.5
        p1, v1, _, _ = _exponential_disk(
            rng, half, R, G, scale_frac=0.25, soft_frac=0.025,
            max_r_frac=0.5, height_frac=0.01, sigma_frac=0.10, spin=1.0)
        p1[:, 0] -= separation / 2
        p2, v2, _, _ = _exponential_disk(
            rng, n2, R, G, scale_frac=0.25, soft_frac=0.025,
            max_r_frac=0.5, height_frac=0.01, sigma_frac=0.10, spin=-1.0)
        p2[:, 0] += separation / 2
        p2[:, 1] += R * 0.15
        # Reference quirk preserved: "total mass" uses n*0.001 even though
        # every particle has mass 1 (presets.py:226).
        escape_vel = np.sqrt(2 * G * (n * 0.001) / separation)
        v1[:, 0] += escape_vel * 0.6
        v2[:, 0] -= escape_vel * 0.6
        positions = np.concatenate([p1, p2])
        velocities = np.concatenate([v1, v2])

    elif distribution == "spiral":
        # Four-arm trailing logarithmic spiral (presets.py:234-298).
        scale_length = R * 0.3
        softening = R * 0.03
        r = rng.exponential(scale_length, n)
        r = r * (1 - np.exp(-(R * 1.0) / (r + 0.01)))
        r = np.maximum(r, R * 0.001)
        tightness, num_arms = 0.35, 4
        base_theta = -np.log(r / (R * 0.02) + 1) / tightness
        arm = rng.integers(0, num_arms, n) * (2 * np.pi / num_arms)
        scatter = 0.12 + 0.15 * (r / R) ** 0.5
        theta = base_theta + arm + rng.normal(0, 1, n) * scatter
        positions[:, 0] = r * np.cos(theta)
        positions[:, 2] = r * np.sin(theta)
        disk_height = R * 0.012 * (1 + (r / R) ** 0.5 * 0.3)
        positions[:, 1] = rng.normal(0, 1, n) * disk_height
        orbital = compute_rotation_curve(r, masses, G, softening)
        reference_speed = np.sqrt(G * (n * 0.001) / (r + softening))
        orbital = np.maximum(orbital, reference_speed * 0.7)
        pos_theta = np.arctan2(positions[:, 2], positions[:, 0])
        velocities[:, 0] = -orbital * np.sin(pos_theta)
        velocities[:, 2] = orbital * np.cos(pos_theta)
        radial_factor = r / (r + softening * 2)
        sigma = orbital * 0.10 * radial_factor + np.sqrt(G * n * 0.00005)
        velocities[:, 0] += rng.normal(0, 1, n) * sigma
        velocities[:, 2] += rng.normal(0, 1, n) * sigma
        velocities[:, 1] = rng.normal(0, 1, n) * (sigma * 0.25)
        velocities = _zero_com_velocity(velocities, masses)

    elif distribution == "ring":
        # Saturn-like ring around a dense heavy core (presets.py:300-327).
        core_n = n // 10
        ring_n = n - core_n
        r_core = rng.exponential(R * 0.05, core_n)
        positions[:core_n] = _sphere_dirs(rng, core_n) * r_core[:, None]
        masses[:core_n] = 10.0
        ring_r = rng.uniform(R * 0.4, R * 0.8, ring_n)
        ring_theta = rng.uniform(0, 2 * np.pi, ring_n)
        positions[core_n:, 0] = ring_r * np.cos(ring_theta)
        positions[core_n:, 1] = rng.normal(0, R * 0.01, ring_n)
        positions[core_n:, 2] = ring_r * np.sin(ring_theta)
        orbital = np.sqrt(G * core_n * 10 * 0.001 / ring_r)
        velocities[core_n:, 0] = -orbital * np.sin(ring_theta)
        velocities[core_n:, 2] = orbital * np.cos(ring_theta)

    elif distribution == "shell":
        # Hollow shell, uniform in volume between 0.7R and 0.9R, slight
        # radial expansion (presets.py:329-348).
        r_in, r_out = R * 0.7, R * 0.9
        u = rng.uniform(0, 1, n)
        r = (r_in ** 3 + u * (r_out ** 3 - r_in ** 3)) ** (1 / 3)
        positions = _sphere_dirs(rng, n) * r[:, None]
        velocities = positions * 0.01

    elif distribution == "cluster":
        # Plummer sphere in approximate virial equilibrium
        # (presets.py:350-397; the reference's per-particle Maxwellian loop
        # is vectorized here).
        a = R * 0.3
        u = rng.uniform(0, 1, n)
        r = a / np.sqrt(u ** (-2 / 3) - 1)
        r = np.clip(r, 0, R * 1.5)
        positions = _sphere_dirs(rng, n) * r[:, None]
        total_mass = n * 0.001
        sigma_sq = G * total_mass / (6 * a) * (1 + (r / a) ** 2) ** -0.5
        sigma = np.sqrt(np.maximum(sigma_sq, G * total_mass / (6 * a) * 0.01))
        v_mag = np.abs(rng.normal(0, 1, n)) * (sigma * np.sqrt(3))
        velocities = _sphere_dirs(rng, n) * v_mag[:, None]
        velocities = _zero_com_velocity(velocities, masses)

    elif distribution == "cube":
        # Cubic lattice, for testing (presets.py:827-835).
        side = int(np.ceil(n ** (1 / 3)))
        grid = np.mgrid[0:side, 0:side, 0:side].reshape(3, -1).T[:n]
        spacing = R * 2 / side
        positions = (grid - side / 2) * spacing
        velocities = rng.normal(0, 0.1, (n, 3))

    elif distribution in DISTRIBUTIONS and distribution != "sphere":
        from spatialsim_tpu_torch._distributions_extra import generate_extra
        return generate_extra(distribution, n, R, G, rng)

    else:
        # Reference default: uniform-in-volume sphere with the quirky
        # r = U(0,R)^(1/3) * R radius law (presets.py:1378-1388).
        positions, velocities, masses = _sphere_default(rng, n, R)

    return positions, velocities, masses


def _sphere_default(rng, n, R):
    positions = np.zeros((n, 3))
    masses = np.ones(n)
    # Quirk preserved from presets.py:1381: radii reach R^(1/3)*R, not R.
    r = rng.uniform(0, R, n) ** (1 / 3) * R
    positions = _sphere_dirs(rng, n) * r[:, None]
    velocities = rng.normal(0, 0.5, (n, 3))
    return positions, velocities, masses
