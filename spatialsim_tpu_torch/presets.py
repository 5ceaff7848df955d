"""Preset catalog for offline recording.

Same catalog as the reference's ``tools/presets.py:1397-2642`` — 66 named
configurations across 9 categories (TINY/FAST/CINEMATIC/CINEMATIC_4K/
ARTISTIC/SCIENTIFIC/CHAOS/MEGA/EXTREME) with identical field values — but
stored as a compact table instead of 1,300 lines of dict literals.  The
reference defines ``"triple_collision"`` twice (``:2016`` and ``:2294``);
dict semantics keep only the second, and so does this table (SURVEY.md §2
C18 quirk — deliberately not replicated as a duplicate).

API mirrors the reference: :data:`PRESETS`, :func:`get_preset_list`,
:func:`get_preset_by_index`, :func:`get_preset_config`,
:func:`print_preset_menu`, :func:`list_distributions`
(``tools/presets.py:2649-2717``) plus :func:`parse_number`
(``tools/record.py:1116-1125``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from spatialsim_tpu_torch.distributions import DISTRIBUTIONS

_FIELDS = ("name", "description", "category", "num_bodies", "theta", "G",
           "softening", "damping", "spawn_radius", "distribution",
           "total_frames", "dt_per_frame", "substeps", "target_fps",
           "estimated_time")

# key, name, description, category, num_bodies, theta, G, softening,
# damping, spawn_radius, distribution, total_frames, dt_per_frame,
# substeps, target_fps, estimated_time
_TABLE = [
    ("galaxy_epic", "Epic Galaxy",
     "Massive spiral galaxy, cinematic quality",
     "CINEMATIC", 500000, 0.7, 0.1, 2.5, 1.0, 600.0, "galaxy", 3000, 0.12, 3, 24, "~1 hour"),
    ("collision_majesty", "Galactic Collision",
     "Two massive galaxies colliding, Andromeda-style",
     "CINEMATIC", 400000, 0.75, 0.12, 2.0, 1.0, 700.0, "collision", 4000, 0.15, 3, 24, "~1 hour"),
    ("spiral_milkyway", "Milky Way Spiral",
     "Four-arm spiral galaxy like our Milky Way",
     "CINEMATIC", 300000, 0.8, 0.08, 2.0, 1.0, 600.0, "spiral", 2500, 0.1, 3, 24, "~30 minutes"),
    ("vortex_cinematic", "Cinematic Vortex",
     "Beautiful tornado vortex with stable orbital dynamics",
     "CINEMATIC", 400000, 0.75, 0.08, 2.0, 0.999, 600.0, "vortex", 3000, 0.1, 4, 24, "~45 minutes"),
    ("bar_galaxy", "Barred Spiral Galaxy",
     "Galaxy with central bar structure, like SBb type",
     "CINEMATIC", 350000, 0.8, 0.09, 2.0, 1.0, 550.0, "bar", 2000, 0.12, 3, 24, "~30 minutes"),
    ("4k_galaxy_500k", "4K Galaxy 500K",
     "500K body galaxy, 4K 60fps quality, high accuracy",
     "CINEMATIC_4K", 500000, 0.5, 0.08, 1.5, 1.0, 600.0, "galaxy", 3600, 0.05, 5, 60, "~5 hours"),
    ("4k_galaxy_1m", "4K Galaxy 1M",
     "1 million body galaxy, ultra cinematic",
     "CINEMATIC_4K", 1000000, 0.5, 0.07, 1.5, 1.0, 800.0, "galaxy", 3600, 0.05, 5, 60, "~11 hours"),
    ("4k_collision_500k", "4K Collision 500K",
     "Two galaxies colliding, 4K 60fps, high accuracy",
     "CINEMATIC_4K", 500000, 0.5, 0.1, 1.5, 1.0, 700.0, "collision", 6000, 0.06, 5, 60, "~9 hours"),
    ("4k_collision_1m", "4K Collision 1M",
     "Epic 1M body collision, production quality",
     "CINEMATIC_4K", 1000000, 0.5, 0.08, 1.5, 1.0, 900.0, "collision", 6000, 0.06, 5, 60, "~18 hours"),
    ("4k_spiral_500k", "4K Spiral 500K",
     "Multi-arm spiral galaxy, 4K 60fps",
     "CINEMATIC_4K", 500000, 0.5, 0.06, 1.5, 1.0, 650.0, "spiral", 3600, 0.05, 5, 60, "~5 hours"),
    ("4k_spiral_1m", "4K Spiral 1M",
     "Stunning 1M body spiral, ultra smooth",
     "CINEMATIC_4K", 1000000, 0.5, 0.05, 1.5, 1.0, 850.0, "spiral", 3600, 0.05, 5, 60, "~11 hours"),
    ("4k_cluster_300k", "4K Globular Cluster",
     "Dense star cluster, ultra accurate physics",
     "CINEMATIC_4K", 300000, 0.4, 0.05, 1.0, 1.0, 300.0, "cluster", 3600, 0.04, 6, 60, "~6 hours"),
    ("4k_ring_400k", "4K Saturn Rings",
     "Beautiful ring system, cinematic quality",
     "CINEMATIC_4K", 400000, 0.5, 0.06, 1.0, 1.0, 400.0, "ring", 3600, 0.05, 5, 60, "~4 hours"),
    ("4k_binary_300k", "4K Binary System",
     "Binary stars with disks, ultra smooth",
     "CINEMATIC_4K", 300000, 0.5, 0.12, 1.0, 1.0, 400.0, "binary", 3600, 0.05, 5, 60, "~3 hours"),
    ("4k_galaxy_long", "4K Galaxy Long",
     "Extended 2-minute galaxy evolution at 60fps",
     "CINEMATIC_4K", 500000, 0.55, 0.07, 1.5, 1.0, 650.0, "galaxy", 7200, 0.05, 4, 60, "~7 hours"),
    ("4k_collision_epic", "4K Collision Epic",
     "3-minute collision drama at 60fps",
     "CINEMATIC_4K", 600000, 0.55, 0.09, 1.5, 1.0, 800.0, "collision", 10800, 0.06, 4, 60, "~12 hours"),
    ("4k_vortex_artistic", "4K Cosmic Vortex",
     "Artistic swirling vortex, high frame count",
     "CINEMATIC_4K", 400000, 0.5, 0.06, 1.5, 0.998, 500.0, "disc", 6000, 0.06, 5, 60, "~7 hours"),
    ("4k_tornado_vortex", "4K Tornado Vortex",
     "Stunning tornado-like vortex with orbital velocity, 4K 60fps",
     "CINEMATIC_4K", 500000, 0.5, 0.08, 1.5, 0.999, 600.0, "vortex", 6000, 0.05, 5, 60, "~8 hours"),
    ("4k_vortex_epic", "4K Epic Vortex",
     "Massive tornado vortex, production quality",
     "CINEMATIC_4K", 800000, 0.5, 0.07, 1.5, 0.999, 700.0, "vortex", 7200, 0.05, 5, 60, "~12 hours"),
    ("4k_supernova_burst", "4K Supernova",
     "Explosive supernova at 60fps, high detail",
     "CINEMATIC_4K", 350000, 0.5, 0.06, 1.2, 1.0, 250.0, "explosion", 3600, 0.05, 5, 60, "~3 hours"),
    ("quick_galaxy", "Quick Galaxy",
     "Fast galaxy simulation for testing",
     "FAST", 100000, 0.95, 0.15, 3.0, 1.0, 500.0, "galaxy", 500, 0.2, 1, 30, "~25 seconds"),
    ("quick_collision", "Quick Collision",
     "Fast collision simulation",
     "FAST", 80000, 0.95, 0.2, 3.5, 1.0, 400.0, "collision", 600, 0.25, 1, 30, "~25 seconds"),
    ("quick_vortex", "Quick Vortex",
     "Fast tornado vortex simulation for testing",
     "FAST", 100000, 0.95, 0.12, 2.5, 0.998, 400.0, "vortex", 600, 0.15, 2, 30, "~30 seconds"),
    ("mini_cluster", "Mini Cluster",
     "Small dense star cluster",
     "FAST", 50000, 0.95, 0.2, 2.0, 1.0, 200.0, "cluster", 400, 0.15, 1, 30, "~10 seconds"),
    ("instant_ring", "Instant Ring",
     "Saturn-like ring, very fast",
     "FAST", 60000, 0.95, 0.1, 2.0, 1.0, 300.0, "ring", 300, 0.2, 1, 30, "~10 seconds"),
    ("accurate_cluster", "Globular Cluster",
     "Physically accurate globular cluster (Plummer model)",
     "SCIENTIFIC", 200000, 0.5, 0.05, 1.0, 1.0, 300.0, "cluster", 2000, 0.08, 4, 24, "~50 minutes"),
    ("elliptical_galaxy", "Elliptical Galaxy",
     "Giant elliptical galaxy (E3 type)",
     "SCIENTIFIC", 250000, 0.6, 0.06, 2.0, 1.0, 500.0, "elliptical", 2000, 0.1, 3, 24, "~35 minutes"),
    ("binary_stars", "Binary Star System",
     "Two stars with protoplanetary disks",
     "SCIENTIFIC", 150000, 0.7, 0.15, 1.5, 1.0, 400.0, "binary", 1500, 0.1, 3, 24, "~11 minutes"),
    ("tidal_stream", "Tidal Stream",
     "Stellar stream from disrupted dwarf galaxy",
     "SCIENTIFIC", 100000, 0.8, 0.05, 2.0, 1.0, 800.0, "stream", 1200, 0.15, 2, 24, "~3 minutes"),
    ("supernova", "Supernova Explosion",
     "Violent expanding shell from stellar explosion",
     "CHAOS", 150000, 0.9, 0.08, 1.5, 1.0, 200.0, "explosion", 1000, 0.12, 2, 30, "~3 minutes"),
    ("cosmic_vortex", "Cosmic Vortex",
     "Swirling maelstrom of stars",
     "CHAOS", 200000, 0.9, 0.08, 2.0, 0.995, 400.0, "disc", 1500, 0.12, 2, 30, "~6 minutes"),
    ("tornado_chaos", "Tornado Chaos",
     "Wild tornado vortex with chaotic dynamics",
     "CHAOS", 300000, 0.9, 0.1, 2.5, 0.992, 500.0, "vortex", 2000, 0.15, 2, 30, "~8 minutes"),
    ("vortex_storm", "Vortex Storm",
     "Intense tornado-like vortex with high energy",
     "CHAOS", 250000, 0.85, 0.12, 2.0, 0.99, 450.0, "vortex", 1800, 0.12, 2, 30, "~7 minutes"),
    ("triple_collision", "Triple Collision",
     "Three galaxies colliding chaotically",
     "MEGA", 300000, 0.82, 0.12, 2.5, 1.0, 800.0, "triple", 2000, 0.15, 3, 24, "~14 minutes"),
    ("gravity_bomb", "Gravity Bomb",
     "Uniform sphere collapsing violently",
     "CHAOS", 200000, 0.9, 0.3, 1.0, 1.0, 500.0, "sphere", 800, 0.1, 2, 30, "~3 minutes"),
    ("nebula_birth", "Star Cluster Birth",
     "Young star cluster emerging from nebula",
     "ARTISTIC", 250000, 0.85, 0.08, 2.0, 1.0, 500.0, "pleiades", 1500, 0.12, 2, 24, "~8 minutes"),
    ("saturn_rings", "Saturn's Rings",
     "Beautiful ring system with dense core",
     "ARTISTIC", 300000, 0.85, 0.08, 1.5, 1.0, 400.0, "ring", 1500, 0.1, 2, 24, "~10 minutes"),
    ("shell_collapse", "Shell Collapse",
     "Hollow shell collapsing inward",
     "ARTISTIC", 200000, 0.85, 0.15, 2.0, 1.0, 400.0, "shell", 1200, 0.12, 2, 24, "~5 minutes"),
    ("cosmic_web", "Cosmic Web",
     "Large-scale structure of the universe (needs millions)",
     "ARTISTIC", 500000, 0.95, 0.02, 5.0, 1.0, 1200.0, "filament", 800, 0.3, 1, 24, "~5 minutes"),
    ("dna_helix", "DNA Double Helix",
     "Mesmerizing double helix structure",
     "ARTISTIC", 150000, 0.9, 0.05, 2.0, 1.0, 400.0, "double_helix", 1200, 0.1, 2, 24, "~4 minutes"),
    ("black_hole", "Black Hole Accretion",
     "Accretion disk with brilliant jets",
     "ARTISTIC", 200000, 0.85, 0.3, 1.5, 1.0, 500.0, "accretion_disk", 1500, 0.08, 3, 30, "~6 minutes"),
    ("tornado_artistic", "Artistic Tornado",
     "Beautiful tornado-like vortex with mesmerizing spiral",
     "ARTISTIC", 350000, 0.85, 0.09, 1.8, 0.998, 550.0, "vortex", 2000, 0.1, 3, 24, "~12 minutes"),
    ("cosmic_tornado", "Cosmic Tornado",
     "Stunning cosmic tornado vortex with orbital dynamics",
     "ARTISTIC", 400000, 0.8, 0.08, 2.0, 0.999, 600.0, "vortex", 2400, 0.1, 3, 24, "~15 minutes"),
    ("cosmic_donut", "Cosmic Torus",
     "Beautiful donut-shaped structure",
     "ARTISTIC", 180000, 0.88, 0.08, 2.0, 1.0, 450.0, "torus", 1200, 0.12, 2, 24, "~5 minutes"),
    ("stellar_hourglass", "Stellar Hourglass",
     "Binary star hourglass nebula",
     "ARTISTIC", 150000, 0.9, 0.1, 2.5, 1.0, 500.0, "hourglass", 1000, 0.15, 2, 24, "~4 minutes"),
    ("golden_spiral", "Fibonacci Spiral",
     "Nature's golden ratio in space",
     "ARTISTIC", 120000, 0.92, 0.06, 2.0, 1.0, 450.0, "fibonacci", 1200, 0.12, 2, 24, "~3 minutes"),
    ("galactic_rosette", "Galactic Rosette",
     "Flower-like orbital pattern",
     "ARTISTIC", 200000, 0.88, 0.1, 2.0, 1.0, 500.0, "rosette", 1500, 0.1, 2, 24, "~6 minutes"),
    ("dyson_sphere", "Dyson Sphere",
     "Megastructure surrounding a star",
     "ARTISTIC", 250000, 0.85, 0.2, 1.5, 1.0, 600.0, "dyson", 1500, 0.08, 3, 30, "~8 minutes"),
    ("million_stars", "Million Star Galaxy",
     "Massive 1M body galaxy (very long render)",
     "MEGA", 1000000, 0.95, 0.1, 3.0, 1.0, 800.0, "galaxy", 2000, 0.15, 2, 24, "~40 minutes"),
    ("mega_collision", "Mega Collision",
     "Two 500K body galaxies colliding",
     "MEGA", 1000000, 0.95, 0.12, 3.5, 1.0, 1000.0, "collision", 3000, 0.15, 2, 24, "~1 hour"),
    ("extreme_5m_galaxy", "5 Million Star Galaxy",
     "Massive galaxy with 5M bodies, approximate physics",
     "EXTREME", 5000000, 1.2, 0.08, 5.0, 1.0, 1200.0, "galaxy", 500, 0.2, 1, 20, "~17 minutes"),
    ("extreme_5m_collision", "5 Million Collision",
     "Epic collision with 5M bodies",
     "EXTREME", 5000000, 1.2, 0.1, 5.0, 1.0, 1500.0, "collision", 500, 0.2, 1, 20, "~17 minutes"),
    ("extreme_5m_spiral", "5 Million Spiral",
     "Gigantic spiral galaxy with 5M stars",
     "EXTREME", 5000000, 1.2, 0.06, 5.0, 1.0, 1400.0, "spiral", 500, 0.2, 1, 20, "~17 minutes"),
    ("extreme_10m_galaxy", "10 Million Star Galaxy",
     "Ultra-massive galaxy with 10M bodies",
     "EXTREME", 10000000, 1.3, 0.06, 6.0, 1.0, 1600.0, "galaxy", 500, 0.25, 1, 20, "~30 minutes"),
    ("extreme_10m_collision", "10 Million Collision",
     "Massive collision with 10M bodies",
     "EXTREME", 10000000, 1.3, 0.08, 6.0, 1.0, 2000.0, "collision", 500, 0.25, 1, 20, "~30 minutes"),
    ("extreme_20m_galaxy", "20 Million Star Galaxy",
     "Hyper-massive galaxy with 20M bodies",
     "EXTREME", 20000000, 1.4, 0.05, 8.0, 1.0, 2000.0, "galaxy", 500, 0.3, 1, 20, "~1 hour"),
    ("extreme_20m_spiral", "20 Million Spiral",
     "Mega spiral galaxy with 20M stars",
     "EXTREME", 20000000, 1.4, 0.04, 8.0, 1.0, 2200.0, "spiral", 500, 0.3, 1, 20, "~1 hour"),
    ("extreme_50m_galaxy", "50 Million Star Galaxy",
     "Insane 50M body galaxy - multi-day render",
     "EXTREME", 50000000, 1.5, 0.04, 10.0, 1.0, 3000.0, "galaxy", 500, 0.35, 1, 20, "~2 hours"),
    ("extreme_50m_collision", "50 Million Collision",
     "Ultimate collision with 50M bodies",
     "EXTREME", 50000000, 1.5, 0.05, 10.0, 1.0, 3500.0, "collision", 500, 0.35, 1, 20, "~2 hours"),
    ("extreme_50m_web", "50 Million Cosmic Web",
     "Ultimate cosmic web - CMB-like large scale structure",
     "EXTREME", 50000000, 1.5, 0.01, 15.0, 1.0, 5000.0, "filament", 500, 0.4, 1, 20, "~2 hours"),
    ("extreme_20m_web", "20 Million Cosmic Web",
     "Massive cosmic web structure",
     "EXTREME", 20000000, 1.4, 0.015, 12.0, 1.0, 4000.0, "filament", 500, 0.4, 1, 20, "~1 hour"),
    ("extreme_10m_web", "10 Million Cosmic Web",
     "Large cosmic web with filaments and voids",
     "EXTREME", 10000000, 1.3, 0.02, 10.0, 1.0, 3000.0, "filament", 500, 0.35, 1, 20, "~30 minutes"),
    ("extreme_5m_web", "5 Million Cosmic Web",
     "Cosmic web with clear filamentary structure",
     "EXTREME", 5000000, 1.2, 0.025, 8.0, 1.0, 2500.0, "filament", 500, 0.35, 1, 20, "~17 minutes"),
    ("tiny_galaxy", "Tiny Galaxy",
     "Very small galaxy for testing",
     "TINY", 10000, 0.95, 0.2, 5.0, 1.0, 200.0, "galaxy", 200, 0.3, 1, 30, "~3 seconds"),
    ("tiny_collision", "Tiny Collision",
     "Very small collision for testing",
     "TINY", 15000, 0.95, 0.25, 5.0, 1.0, 250.0, "collision", 250, 0.3, 1, 30, "~5 seconds"),
    ("demo_cluster", "Demo Cluster",
     "Quick demo of cluster dynamics",
     "TINY", 20000, 0.95, 0.15, 3.0, 1.0, 150.0, "cluster", 300, 0.2, 1, 30, "~5 seconds"),]

PRESETS: Dict[str, dict] = {
    row[0]: dict(zip(_FIELDS, row[1:])) for row in _TABLE
}

CATEGORY_ORDER = ["TINY", "FAST", "CINEMATIC", "CINEMATIC_4K", "ARTISTIC",
                  "SCIENTIFIC", "CHAOS", "MEGA", "EXTREME"]

# One-line descriptions for the distribution menu (the reference keeps
# these in its DISTRIBUTIONS dict, tools/presets.py:25-50).
DISTRIBUTION_DESCRIPTIONS = {
    "galaxy": "Spinning disk galaxy with rotation-curve orbits",
    "collision": "Two galaxies on a collision course",
    "spiral": "Four-arm logarithmic spiral galaxy",
    "ring": "Saturn-like ring around a dense core",
    "shell": "Hollow expanding shell",
    "cluster": "Plummer globular cluster in equilibrium",
    "binary": "Binary stars with tilted protoplanetary disks",
    "elliptical": "Pressure-supported triaxial elliptical",
    "bar": "Barred spiral galaxy",
    "stream": "Sinusoidal tidal stream",
    "filament": "Cosmic-web filaments with voids",
    "explosion": "Supernova shell expansion",
    "disc": "Flat rotating disc with outflow",
    "vortex": "Tornado-like funnel vortex",
    "cube": "Cubic lattice (for testing)",
    "pleiades": "Young cluster with nebulosity",
    "double_helix": "DNA-like double helix",
    "accretion_disk": "Black-hole accretion disk with jets",
    "torus": "Orbiting donut",
    "hourglass": "Binary-star hourglass nebula",
    "fibonacci": "Golden-angle spiral column",
    "triple": "Three galaxies on a triangle orbit",
    "rosette": "Five-petal orbital rosette",
    "dyson": "Dyson sphere around a massive star",
    "sphere": "Uniform sphere (default)",
}


def get_preset_list() -> List[Tuple[str, dict]]:
    """All presets sorted by category then key (reference ordering)."""
    def sort_key(item):
        cat = item[1]["category"]
        rank = CATEGORY_ORDER.index(cat) if cat in CATEGORY_ORDER else 99
        return (rank, item[0])
    return sorted(PRESETS.items(), key=sort_key)


def get_preset_by_index(index: int) -> Tuple[Optional[str], Optional[dict]]:
    presets = get_preset_list()
    if 0 <= index < len(presets):
        return presets[index]
    return None, None


def get_preset_config(key: str) -> Optional[dict]:
    """Copy of a preset with ``session_name`` filled in, or None."""
    if key not in PRESETS:
        return None
    preset = dict(PRESETS[key])
    preset["session_name"] = key
    return preset


def _fmt_bodies(n: int) -> str:
    return f"{n / 1_000_000:.1f}M" if n >= 1_000_000 else f"{n // 1000}K"


def print_preset_menu() -> None:
    presets = get_preset_list()
    bar = "=" * 70
    print(f"\n{bar}\n  N-BODY SIMULATION RECORDING PRESETS\n{bar}")
    category = None
    for idx, (key, p) in enumerate(presets):
        if p["category"] != category:
            category = p["category"]
            rule = "─" * 70
            print(f"\n{rule}\n  {category}\n{rule}")
        print(f"  [{idx:2d}] {p['name']:<25} {_fmt_bodies(p['num_bodies']):>6}"
              f" bodies | {p['total_frames']:>4} frames | "
              f"{p.get('estimated_time', '?')}")
        print(f"       {p['description']}")
    print(f"\n{bar}")
    print(f"  Enter number [0-{len(presets) - 1}] to select, or 'q' to quit")
    print(bar)


def list_distributions() -> None:
    print("\nAvailable spawn distributions:\n" + "-" * 40)
    for name in DISTRIBUTIONS:
        print(f"  {name:<15} - {DISTRIBUTION_DESCRIPTIONS.get(name, '')}")


def parse_number(text: str) -> int:
    """Parse counts with k/m suffixes: '500k' -> 500000, '1.5m' -> 1500000
    (reference tools/record.py:1116-1125)."""
    s = str(text).strip().lower().replace(",", "")
    if s.endswith("m"):
        return int(float(s[:-1]) * 1_000_000)
    if s.endswith("k"):
        return int(float(s[:-1]) * 1_000)
    return int(float(s))
