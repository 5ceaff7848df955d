"""The remaining named initial-condition generators.

Companion to :mod:`spatialsim_tpu.distributions` — these are the 17
distributions of the reference's ``generate_distribution``
(``tools/presets.py:399-1390``) not covered by the shared disk/cluster
recipes: binary, elliptical, bar, stream, filament, explosion, disc, vortex,
pleiades, double_helix, accretion_disk, torus, hourglass, fibonacci, triple,
rosette, dyson.  Same statistical recipes, but the reference's per-particle
Python loops (e.g. the elliptical isotropic sampler at
``tools/presets.py:520-533``, the torus tangent loop at ``:1000-1012``) are
vectorized, and every draw goes through the caller's seedable Generator.
"""

from __future__ import annotations

import numpy as np


def _sphere_dirs(rng, n):
    phi = rng.uniform(0, 2 * np.pi, n)
    cos_t = rng.uniform(-1, 1, n)
    sin_t = np.sqrt(1 - cos_t ** 2)
    return np.stack([sin_t * np.cos(phi), cos_t, sin_t * np.sin(phi)], axis=1)


def _zero_com_velocity(velocities, masses):
    com_vel = np.sum(velocities * masses[:, None], axis=0) / np.sum(masses)
    return velocities - com_vel


def _rotation_curve(r, masses, G, softening):
    # Local import avoids a cycle with the main module.
    from spatialsim_tpu_torch.distributions import compute_rotation_curve
    return compute_rotation_curve(r, masses, G, softening)


def _xz_tangent(pos, speed):
    """Tangential velocity around the y axis: v = speed * (-z, 0, x)/r_xz.

    The reference computes this per particle in several generators
    (``tools/presets.py:1000-1012`` torus, ``:1100-1111`` hourglass); here it
    is one vectorized expression, with near-axis particles zeroed exactly as
    the reference's ``r_xy > 0.01`` guard does.
    """
    r_xz = np.sqrt(pos[:, 0] ** 2 + pos[:, 2] ** 2)
    safe = np.maximum(r_xz, 1e-10)
    vel = np.zeros_like(pos)
    vel[:, 0] = -speed * pos[:, 2] / safe
    vel[:, 2] = speed * pos[:, 0] / safe
    vel[r_xz <= 0.01] = 0.0
    return vel


def generate_extra(distribution, n, R, G, rng):
    positions = np.zeros((n, 3))
    velocities = np.zeros((n, 3))
    masses = np.ones(n)

    if distribution == "binary":
        # Two Keplerian protoplanetary disks orbiting their common COM,
        # disk 2 tilted 30 deg (presets.py:399-471).
        n1 = n // 2
        n2 = n - n1
        total_mass = n * 0.001
        separation = R * 0.5
        binary_speed = np.sqrt(G * total_mass / separation)

        r1 = np.clip(rng.exponential(R * 0.12, n1), R * 0.01, R * 0.25)
        th1 = rng.uniform(0, 2 * np.pi, n1)
        positions[:n1, 0] = r1 * np.cos(th1) - separation / 2
        positions[:n1, 1] = rng.normal(0, R * 0.008, n1)
        positions[:n1, 2] = r1 * np.sin(th1)
        orb1 = np.sqrt(G * (n1 * 0.001) / (r1 + R * 0.01))
        velocities[:n1, 0] = -orb1 * np.sin(th1)
        velocities[:n1, 2] = orb1 * np.cos(th1) - binary_speed * (n2 / n)

        r2 = np.clip(rng.exponential(R * 0.12, n2), R * 0.01, R * 0.25)
        th2 = rng.uniform(0, 2 * np.pi, n2)
        tilt = np.pi / 6
        positions[n1:, 0] = r2 * np.cos(th2) + separation / 2
        positions[n1:, 1] = r2 * np.sin(th2) * np.sin(tilt)
        positions[n1:, 2] = r2 * np.sin(th2) * np.cos(tilt)
        orb2 = np.sqrt(G * (n2 * 0.001) / (r2 + R * 0.01))
        velocities[n1:, 0] = -orb2 * np.sin(th2)
        velocities[n1:, 1] = orb2 * np.cos(th2) * np.sin(tilt)
        velocities[n1:, 2] = orb2 * np.cos(th2) * np.cos(tilt) \
            + binary_speed * (n1 / n)

        sigma = np.sqrt(G * (n1 * 0.001) / (R * 0.1)) * 0.05
        velocities += rng.normal(0, sigma, (n, 3))
        velocities = _zero_com_velocity(velocities, masses)

    elif distribution == "elliptical":
        # Triaxial pressure-supported ellipsoid, Jeans-like dispersion
        # (presets.py:475-534).
        a, b, c = R * 0.5, R * 0.4, R * 0.3
        r = np.clip(rng.exponential(R * 0.2, n), 0, R * 0.9)
        dirs = _sphere_dirs(rng, n)
        positions[:, 0] = a * r / R * dirs[:, 0]
        positions[:, 1] = b * r / R * dirs[:, 1]
        positions[:, 2] = c * r / R * dirs[:, 2]
        total_mass = n * 0.001
        r_eff = np.sqrt((positions[:, 0] / a) ** 2 + (positions[:, 1] / b) ** 2
                        + (positions[:, 2] / c) ** 2) * R
        m_frac = np.clip((r_eff / (R * 0.9)) ** 1.5, 0.01, 1.0)
        sigma_sq = G * total_mass * m_frac / (r_eff + R * 0.05)
        sigma = np.sqrt(np.maximum(sigma_sq, G * total_mass / (R * 10)))
        v_mag = np.abs(rng.normal(0, 1, n)) * sigma * np.sqrt(3)
        velocities = _sphere_dirs(rng, n) * v_mag[:, None]
        velocities = _zero_com_velocity(velocities, masses)

    elif distribution == "bar":
        # Central bar + two-arm outer spiral disk (presets.py:536-592).
        bar_n = n // 3
        disk_n = n - bar_n
        softening = R * 0.025

        bar_r = np.clip(rng.exponential(R * 0.4 * 0.3, bar_n), R * 0.01, R * 0.4)
        bar_th = rng.uniform(-np.pi / 6, np.pi / 6, bar_n)
        positions[:bar_n, 0] = bar_r * np.cos(bar_th)
        positions[:bar_n, 1] = rng.normal(0, R * 0.02, bar_n)
        positions[:bar_n, 2] = bar_r * np.sin(bar_th) * 0.3
        bar_v = _rotation_curve(bar_r, masses[:bar_n], G, softening)
        velocities[:bar_n, 0] = -bar_v * np.sin(bar_th)
        velocities[:bar_n, 2] = bar_v * np.cos(bar_th)
        sig_b = bar_v * 0.12 * (bar_r / (bar_r + softening * 2))
        velocities[:bar_n, 0] += rng.normal(0, 1, bar_n) * sig_b
        velocities[:bar_n, 1] += rng.normal(0, 1, bar_n) * sig_b * 0.3
        velocities[:bar_n, 2] += rng.normal(0, 1, bar_n) * sig_b

        disk_r = np.clip(rng.exponential(R * 0.3, disk_n), R * 0.25, R * 0.85)
        spiral_th = np.log(disk_r / (R * 0.1) + 1) / 0.4
        arm = rng.integers(0, 2, disk_n)
        disk_th = spiral_th + arm * np.pi + rng.normal(0, 0.25, disk_n)
        positions[bar_n:, 0] = disk_r * np.cos(disk_th)
        positions[bar_n:, 1] = rng.normal(0, R * 0.01, disk_n)
        positions[bar_n:, 2] = disk_r * np.sin(disk_th)
        disk_v = _rotation_curve(disk_r, masses[bar_n:], G, softening)
        velocities[bar_n:, 0] = -disk_v * np.sin(disk_th)
        velocities[bar_n:, 2] = disk_v * np.cos(disk_th)
        sig_d = disk_v * 0.12 * (disk_r / (disk_r + softening * 2))
        velocities[bar_n:, 0] += rng.normal(0, 1, disk_n) * sig_d
        velocities[bar_n:, 1] += rng.normal(0, 1, disk_n) * sig_d * 0.25
        velocities[bar_n:, 2] += rng.normal(0, 1, disk_n) * sig_d
        velocities = _zero_com_velocity(velocities, masses)

    elif distribution == "stream":
        # Sinusoidal tidal stream drifting along +x (presets.py:594-607).
        t = rng.uniform(0, 1, n)
        positions[:, 0] = (t - 0.5) * R * 3
        positions[:, 1] = np.sin(t * 4 * np.pi) * R * 0.3 + rng.normal(0, R * 0.03, n)
        positions[:, 2] = np.cos(t * 4 * np.pi) * R * 0.3 + rng.normal(0, R * 0.03, n)
        velocities[:, 0] = 5.0 + rng.normal(0, 0.5, n)
        velocities[:, 1] = rng.normal(0, 0.3, n)
        velocities[:, 2] = rng.normal(0, 0.3, n)

    elif distribution == "filament":
        # Cosmic web: 8^3 node grid, ~35% active, power-law weights,
        # filamentary elongation per node, Hubble flow 0.05
        # (presets.py:609-693).
        grid_size = 8
        node_spacing = R * 2.5 / grid_size
        coords = np.linspace(-R * 1.25, R * 1.25, grid_size)
        cx, cy, cz = np.meshgrid(coords, coords, coords, indexing="ij")
        centers = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)
        active = rng.random(len(centers)) < 0.35
        if not np.any(active):
            active[0] = True
        centers = centers[active]
        num_active = len(centers)
        w = rng.power(2.0, num_active)
        w /= w.sum()
        node_of = rng.choice(num_active, size=n, p=w)

        # Per-node random orthonormal frame (elongation + 2 perpendiculars).
        e = rng.normal(size=(num_active, 3))
        e /= np.linalg.norm(e, axis=1, keepdims=True) + 1e-10
        p1 = rng.normal(size=(num_active, 3))
        p1 -= np.sum(p1 * e, axis=1, keepdims=True) * e
        p1 /= np.linalg.norm(p1, axis=1, keepdims=True) + 1e-10
        p2 = np.cross(e, p1)
        p2 /= np.linalg.norm(p2, axis=1, keepdims=True) + 1e-10

        par = rng.normal(0, node_spacing * 0.8, n)
        o1 = rng.normal(0, node_spacing * 0.12, n)
        o2 = rng.normal(0, node_spacing * 0.12, n)
        positions = (centers[node_of] + par[:, None] * e[node_of]
                     + o1[:, None] * p1[node_of] + o2[:, None] * p2[node_of])
        velocities = positions * 0.05 + rng.normal(0, 0.3, (n, 3))
        masses[:] = 0.1

    elif distribution == "explosion":
        # Supernova: dense slow core + expanding shell, radial shock
        # velocities growing with radius (presets.py:695-744).
        core_n = int(n * 0.15)
        shell_n = n - core_n
        core_r = np.clip(rng.exponential(R * 0.02, core_n), 0, R * 0.05)
        positions[:core_n] = _sphere_dirs(rng, core_n) * core_r[:, None]
        shell_r = rng.uniform(R * 0.05, R * 0.25, shell_n)
        positions[core_n:] = _sphere_dirs(rng, shell_n) * shell_r[:, None]

        dist = np.linalg.norm(positions, axis=1, keepdims=True) + 0.01
        speed = 8.0 * (1.0 + (dist[:, 0] / R) * 2.0) + rng.exponential(3.0, n)
        velocities = positions / dist * speed[:, None]
        velocities *= rng.normal(1.0, 0.15, (n, 3))
        velocities[:core_n] *= 0.6
        masses[:core_n] = 2.0
        masses[core_n:] = 0.5

    elif distribution == "disc":
        # Flat rotating disc with vertical outflow (presets.py:746-760).
        r = rng.exponential(R * 0.3, n)
        theta = rng.uniform(0, 2 * np.pi, n)
        z = rng.normal(0, R * 0.1, n)
        positions[:, 0] = r * np.cos(theta)
        positions[:, 1] = z
        positions[:, 2] = r * np.sin(theta)
        tangent = 8.0 / (r / R + 0.2)
        velocities[:, 0] = -tangent * np.sin(theta)
        velocities[:, 2] = tangent * np.cos(theta)
        velocities[:, 1] = 2.0 * np.sign(z)

    elif distribution == "vortex":
        # Tornado funnel: radius shrinks with |y|, continuous spiral wrap,
        # rotation-curve orbits + tanh vertical flow (presets.py:762-825).
        z = rng.uniform(-R * 0.7, R * 0.7, n)
        hn = np.abs(z) / (R * 0.7 + 0.01)
        hf = np.clip(1.0 - 0.5 * hn ** 1.5, 0.15, 1.0)
        r = rng.exponential(R * 0.25, n) * hf
        theta = rng.uniform(0, 2 * np.pi, n) + z * 0.5 / R
        positions[:, 0] = r * np.cos(theta)
        positions[:, 1] = z
        positions[:, 2] = r * np.sin(theta)
        softening = R * 0.02
        orbital = _rotation_curve(r, masses, G, softening)
        orbital = np.maximum(orbital, np.sqrt(G * n * 0.0001 / (r + softening)))
        velocities[:, 0] = -orbital * np.sin(theta)
        velocities[:, 2] = orbital * np.cos(theta)
        velocities[:, 1] = 0.05 * (r / R + 0.05) * orbital * np.tanh(z / (R * 0.3))
        sigma = orbital * 0.03
        velocities[:, 0] += rng.normal(0, 1, n) * sigma
        velocities[:, 2] += rng.normal(0, 1, n) * sigma
        velocities[:, 1] += rng.normal(0, 1, n) * sigma * 0.15
        velocities = _zero_com_velocity(velocities, masses)

    elif distribution == "pleiades":
        # Bright heavy core cluster inside a flattened nebula
        # (presets.py:837-866).
        core_n = n // 5
        neb_n = n - core_n
        core_r = rng.exponential(R * 0.1, core_n)
        positions[:core_n] = _sphere_dirs(rng, core_n) * core_r[:, None]
        masses[:core_n] = 5.0
        neb_r = rng.exponential(R * 0.5, neb_n) + R * 0.1
        neb = _sphere_dirs(rng, neb_n) * neb_r[:, None]
        neb[:, 1] *= 0.5
        positions[core_n:] = neb
        sigma = np.sqrt(G * core_n * 5 * 0.001 / (R * 0.2))
        velocities = rng.normal(0, sigma * 0.5, (n, 3))

    elif distribution == "double_helix":
        # Two intertwined helices spinning rigidly about y
        # (presets.py:868-905).
        t = np.linspace(0, 6 * np.pi, n)
        radius, pitch = R * 0.25, R * 2.0
        half = n // 2
        phase = np.where(np.arange(n) < half, 0.0, np.pi)
        positions[:, 0] = radius * np.cos(t + phase)
        positions[:, 1] = (t / (6 * np.pi)) * pitch - pitch / 2
        positions[:, 2] = radius * np.sin(t + phase)
        positions += rng.normal(0, R * 0.01, (n, 3))
        omega = 0.08
        r_xz = np.sqrt(positions[:, 0] ** 2 + positions[:, 2] ** 2)
        on_axis = r_xz <= 0.01
        velocities[:, 0] = np.where(on_axis, 0.0, -omega * positions[:, 2])
        velocities[:, 2] = np.where(on_axis, 0.0, omega * positions[:, 0])
        velocities[:, 1] = rng.normal(0, omega * 0.2, n)

    elif distribution == "accretion_disk":
        # Massive compact BH particles + Kepler disk + bipolar jets
        # (presets.py:907-978).
        central_n = max(1, n // 100)
        disk_n = int((n - central_n) * 0.85)
        jet_n = n - central_n - disk_n

        positions[:central_n] = rng.normal(0, R * 0.02, (central_n, 3))
        masses[:central_n] = 200.0
        positions[:central_n] -= positions[:central_n].mean(axis=0)
        velocities[:central_n] = rng.normal(0, 0.1, (central_n, 3))
        velocities[:central_n] -= velocities[:central_n].mean(axis=0)

        central_mass = 1000.0
        r_d = np.clip(rng.exponential(R * 0.2, disk_n), R * 0.05, R * 0.8)
        th_d = rng.uniform(0, 2 * np.pi, disk_n)
        d0, d1 = central_n, central_n + disk_n
        positions[d0:d1, 0] = r_d * np.cos(th_d)
        positions[d0:d1, 1] = rng.normal(0, R * 0.01, disk_n)
        positions[d0:d1, 2] = r_d * np.sin(th_d)
        v_kep = np.sqrt(G * central_mass / (r_d + R * 0.05))
        velocities[d0:d1, 0] = -v_kep * np.sin(th_d)
        velocities[d0:d1, 2] = v_kep * np.cos(th_d)
        masses[d0:d1] = 0.5

        if jet_n > 0:
            sign = np.where(np.arange(jet_n) < jet_n // 2, 1.0, -1.0)
            z_j = rng.uniform(R * 0.2, R * 1.2, jet_n) * sign
            r_j = rng.exponential(R * 0.05, jet_n)
            th_j = rng.uniform(0, 2 * np.pi, jet_n)
            positions[d1:, 0] = r_j * np.cos(th_j)
            positions[d1:, 1] = z_j
            positions[d1:, 2] = r_j * np.sin(th_j)
            velocities[d1:, 1] = 3.0 * sign
            masses[d1:] = 0.1

    elif distribution == "torus":
        # Donut orbiting its major axis (presets.py:980-1017).
        major, minor = R * 0.6, R * 0.25
        u = rng.uniform(0, 2 * np.pi, n)
        v = rng.uniform(0, 2 * np.pi, n)
        r_noise = rng.normal(1.0, 0.1, n)
        positions[:, 0] = (major + minor * np.cos(u) * r_noise) * np.cos(v)
        positions[:, 1] = minor * np.sin(u) * r_noise
        positions[:, 2] = (major + minor * np.cos(u) * r_noise) * np.sin(v)
        omega = np.sqrt(G * n * 0.001 / major)
        velocities = _xz_tangent(positions, omega)
        velocities += rng.normal(0, omega * 0.05, (n, 3))

    elif distribution == "hourglass":
        # Massive central binary + two nebular cones in tangential orbit
        # (presets.py:1019-1111).
        binary_n = max(2, n // 200)
        nebula_n = n - binary_n
        half = nebula_n // 2
        b1 = binary_n // 2
        b2 = binary_n - b1
        sep = R * 0.05
        positions[:b1] = rng.normal(0, R * 0.01, (b1, 3))
        positions[:b1, 0] += -sep / 2
        positions[b1:binary_n] = rng.normal(0, R * 0.01, (b2, 3))
        positions[b1:binary_n, 0] += sep / 2
        masses[:binary_n] = 100.0
        com = (positions[:binary_n] * masses[:binary_n, None]).sum(0) \
            / masses[:binary_n].sum()
        positions[:binary_n] -= com
        v_b = np.sqrt(G * 250.0 / sep)
        velocities[:b1, 1] = rng.normal(0, 0.05, b1)
        velocities[:b1, 2] = v_b + rng.normal(0, 0.05, b1)
        velocities[b1:binary_n, 1] = rng.normal(0, 0.05, b2)
        velocities[b1:binary_n, 2] = -v_b + rng.normal(0, 0.05, b2)
        velocities[:binary_n] = _zero_com_velocity(
            velocities[:binary_n], masses[:binary_n])

        central_mass = 500.0
        z_up = rng.uniform(0, R, half)
        r_up = z_up * 0.5 * (1 + rng.normal(0, 0.1, half))
        th_up = rng.uniform(0, 2 * np.pi, half)
        positions[binary_n:binary_n + half, 0] = r_up * np.cos(th_up)
        positions[binary_n:binary_n + half, 1] = z_up
        positions[binary_n:binary_n + half, 2] = r_up * np.sin(th_up)
        lo = nebula_n - half
        z_dn = rng.uniform(-R, 0, lo)
        r_dn = -z_dn * 0.5 * (1 + rng.normal(0, 0.1, lo))
        th_dn = rng.uniform(0, 2 * np.pi, lo)
        positions[binary_n + half:, 0] = r_dn * np.cos(th_dn)
        positions[binary_n + half:, 1] = z_dn
        positions[binary_n + half:, 2] = r_dn * np.sin(th_dn)

        neb = positions[binary_n:]
        r3 = np.linalg.norm(neb, axis=1)
        v_orb = np.sqrt(G * central_mass / (r3 + R * 0.05))
        velocities[binary_n:] = _xz_tangent(neb, v_orb)
        velocities[binary_n:, 1] = rng.normal(0, 1, nebula_n) \
            * v_orb * (r3 / R) * 0.08
        velocities[binary_n:] += rng.normal(0, 0.08, (nebula_n, 3))
        masses[binary_n:] = 0.1

    elif distribution == "fibonacci":
        # Golden-angle spiral column with Keplerian tangents
        # (presets.py:1113-1145).
        i = np.arange(n)
        golden_angle = 2 * np.pi / (((1 + np.sqrt(5)) / 2) ** 2)
        theta = i * golden_angle
        r = np.where(i > 0, R * np.sqrt(i / n), R * 0.01)
        positions[:, 0] = r * np.cos(theta)
        positions[:, 1] = (i / n - 0.5) * R * 2
        positions[:, 2] = r * np.sin(theta)
        central_mass = n * 0.001
        v_orb = np.sqrt(G * central_mass / (r + R * 0.05))
        far = r > 0.01
        velocities[:, 0] = np.where(far, -v_orb * np.sin(theta), 0.0)
        velocities[:, 2] = np.where(far, v_orb * np.cos(theta), 0.0)
        velocities += rng.normal(0, 0.05, (n, 3))

    elif distribution == "triple":
        # Three compact disk galaxies on an equilateral triangle with a
        # common circular orbit (presets.py:1147-1210).
        third = n // 3
        scale_length = R * 0.20
        softening = R * 0.02
        sep = R * 0.8
        angles = np.array([0, 2 * np.pi / 3, 4 * np.pi / 3])
        centers = np.stack([sep * np.cos(angles), np.zeros(3),
                            sep * np.sin(angles)], axis=1)
        total_mass = n * 0.001
        v_common = np.sqrt(G * total_mass / (sep * np.sqrt(3)))
        for g in range(3):
            start = g * third
            end = start + third if g < 2 else n
            gn = end - start
            r = rng.exponential(scale_length, gn)
            r = np.maximum(r * (1 - np.exp(-(R * 0.3) / (r + 0.01))), R * 0.001)
            theta = rng.uniform(0, 2 * np.pi, gn)
            positions[start:end, 0] = r * np.cos(theta) + centers[g, 0]
            positions[start:end, 1] = rng.normal(0, R * 0.01, gn)
            positions[start:end, 2] = r * np.sin(theta) + centers[g, 2]
            orb = _rotation_curve(r, masses[start:end], G, softening)
            velocities[start:end, 0] = -orb * np.sin(theta)
            velocities[start:end, 2] = orb * np.cos(theta)
            sig = orb * 0.12 * (r / (r + softening * 2)) \
                + np.sqrt(G * gn * 0.00005)
            velocities[start:end, 0] += rng.normal(0, 1, gn) * sig
            velocities[start:end, 1] += rng.normal(0, 1, gn) * sig * 0.25
            velocities[start:end, 2] += rng.normal(0, 1, gn) * sig
            velocities[start:end, 0] += -v_common * centers[g, 2] / sep
            velocities[start:end, 2] += v_common * centers[g, 0] / sep
        velocities = _zero_com_velocity(velocities, masses)

    elif distribution == "rosette":
        # Five elliptical petals rotated around y, distance-scaled angular
        # speed (presets.py:1212-1258).
        num_petals = 5
        petal_size = n // num_petals
        for petal in range(num_petals):
            start = petal * petal_size
            end = start + petal_size if petal < num_petals - 1 else n
            pn = end - start
            ang = petal * 2 * np.pi / num_petals
            r = rng.exponential(R * 0.25, pn)
            theta = rng.uniform(0, 2 * np.pi, pn)
            xl = r * np.cos(theta)
            zl = r * np.sin(theta) * 0.3
            positions[start:end, 0] = xl * np.cos(ang) - zl * np.sin(ang)
            positions[start:end, 1] = rng.normal(0, R * 0.02, pn)
            positions[start:end, 2] = xl * np.sin(ang) + zl * np.cos(ang)
            p = positions[start:end]
            r3 = np.linalg.norm(p, axis=1)
            omega = 0.5 * np.sqrt(R * 0.3 / (r3 + R * 0.05))
            velocities[start:end] = _xz_tangent(p, omega)
        velocities += rng.normal(0, 0.05, (n, 3))

    elif distribution == "dyson":
        # Massive central star + orbiting shell with enclosed-mass-correct
        # circular speeds and y-cross tangents (presets.py:1260-1376).
        central_n = max(1, n // 200)
        shell_n = n - central_n
        positions[:central_n] = rng.normal(0, R * 0.01, (central_n, 3))
        masses[:central_n] = 500.0
        positions[:central_n] -= positions[:central_n].mean(axis=0)
        velocities[:central_n] = rng.normal(0, 0.05, (central_n, 3))
        velocities[:central_n] -= velocities[:central_n].mean(axis=0)

        r = R * 0.7 + rng.normal(0, R * 0.03, shell_n)
        shell = _sphere_dirs(rng, shell_n) * r[:, None]
        positions[central_n:] = shell
        masses[central_n:] = 0.1

        central_mass = masses[:central_n].sum()
        order = np.argsort(r)
        enclosed = np.empty(shell_n)
        enclosed[order] = central_mass + np.cumsum(masses[central_n:][order])
        v_orb = np.sqrt(G * enclosed / (r + R * 0.01))

        r_mag = np.linalg.norm(shell, axis=1)
        valid = r_mag > 0.01
        radial = shell / np.maximum(r_mag, 1e-10)[:, None]
        tangent = np.cross(radial, np.array([0.0, 1.0, 0.0]))
        t_mag = np.linalg.norm(tangent, axis=1)
        poles = t_mag < 0.01
        tangent[poles] = np.cross(radial[poles], np.array([1.0, 0.0, 0.0]))
        t_mag = np.linalg.norm(tangent, axis=1)
        tangent /= (t_mag[:, None] + 1e-10)
        velocities[central_n:][valid] = v_orb[valid, None] * tangent[valid]
        if np.any(~valid):
            velocities[central_n:][~valid] = rng.normal(
                0, 0.01, (np.sum(~valid), 3))
        # Small out-of-plane wobble (1% of orbital speed), vectorized
        # version of the per-particle loop at presets.py:1357-1369.
        vert = np.cross(shell, velocities[central_n:])
        v_mag = np.linalg.norm(vert, axis=1)
        ok = valid & (v_mag > 0.01)
        vert[ok] /= v_mag[ok, None]
        wob = rng.normal(0, 1, shell_n) * v_orb * 0.01
        velocities[central_n:][ok] += vert[ok] * wob[ok, None]

    else:
        raise ValueError(f"unknown distribution {distribution!r}")

    return positions, velocities, masses
