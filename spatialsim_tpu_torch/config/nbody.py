"""N-body configuration.

Field names and default values follow the reference ``config/nbody.py:57-73``
(count=150_000, G=0.1, theta=0.8, softening=2.0, damping=1.0,
spawn_radius=500, distribution="galaxy", max_speed_color=15.0) so presets and
recordings are interchangeable.  Physics fields are plain Python floats: they
are baked into the jitted step as compile-time constants, which lets XLA fold
them (changing them triggers a recompile, matching how the reference re-JITs
nothing but simply re-reads config at construction time).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NBodyConfig:
    """Physics + sizing parameters for one N-body simulation."""

    num_bodies: int = 150_000
    spawn_radius: float = 500.0

    # Physics (reference config/nbody.py:61-66)
    G: float = 0.1
    theta: float = 0.8
    softening: float = 2.0
    damping: float = 1.0

    # Initial distribution name (any of spatialsim_tpu.distributions.DISTRIBUTIONS)
    distribution: str = "galaxy"

    # Rendering / colouring (reference config/nbody.py:71-73)
    point_size: float = 1.5
    max_speed_color: float = 15.0

    # --- TPU-native tuning knobs (no reference equivalent) ---
    # Barnes-Hut engine geometry; see spatialsim_tpu/ops/octree.py.
    # Fields marked "0 = auto" are resolved by body count in
    # resolve_config() — the values below were validated against a
    # direct-sum force oracle at 1M/10M (scripts/nbody_error_scan.py).
    max_depth: int = 0           # octree depth; 0 = auto by N
    leaf_size: int = 8           # cells with <= leaf_size bodies are leaves
    group_size: int = 0          # bodies per Morton group; 0 = auto by N
    list_capacity: int = 0       # far-list capacity per group; 0 = auto
    near_capacity: int = 2048    # near-field body list per group
    frontier_capacity: int = 1024  # traversal frontier per group per level
    # All-pairs vs Barnes-Hut switch (reference picks backends by N at
    # nbody/gpu_backend.py:618-620; we switch algorithm instead of device).
    allpairs_threshold: int = 32_768

    # Production engine (ops/bh_window.py): amortized interaction lists.
    #   engine: "auto" (windowed above allpairs_threshold), "exact"
    #   (per-step reference-parity traversal), "window" (amortized).
    engine: str = "auto"
    window_groups: int = 2       # Morton window half-width, in groups
    # Spatial neighbour groups evaluated EXACTLY alongside the Morton
    # window.  Measured (scripts/seam_analysis.py): ~85% of far-list
    # entries lie within 2 group radii — spatially-adjacent cells the
    # contiguous Morton window misses across octant seams, which the
    # traversal then opens to max depth.  Each group instead picks its
    # near_groups closest groups (bbox gap) at rebuild; their bodies
    # join the near field (block reads, no gathers) and the traversal
    # drops any cell wholly inside the covered ranges — collapsing both
    # deep worklist demand and far-list length.  0 disables (the
    # sharded path forces 0: neighbour groups may live outside the
    # halo).
    near_groups: int = 0
    # Acceptance-dilation margin.  Measured at 1M (scripts/staleness_scan
    # + quad_scan): drift outruns any practical skin within ~6 steps, so
    # stale-list error is governed by the entry ADVANCE (advance_order),
    # not the skin — while a big skin inflates deep-level traversal
    # demand ~45% and saturates the worklist (which *worsened* fresh rms
    # 3.2% -> 4.2% at skin 6).  2.0 keeps a small margin at the measured
    # error optimum.
    skin: float = 2.0
    # Max steps between list rebuilds.  24 is the measured honest
    # default at 1M θ=0.8 with the order-2 advance (docs/measurements_r4
    # staleness scans): worst-of-interval force rms at τ=24 is 5.7%
    # frozen / 5.8% with refresh@12 — AT the fresh-rebuild floor
    # (5.4-5.8%) — while τ=48 degrades to 19.9% (refresh@12) / 25.5%
    # (frozen), which fails the ≤10% production bar.  Past τ≈24 the
    # dominant aging is GEOMETRIC (build-time acceptance + frozen
    # Morton windows vs drift), which no moment refresh can fix.
    rebuild_interval: int = 24
    # Moment refresh cadence (steps; 0 = off): between full rebuilds,
    # re-materialize every far entry's monopole moments from prefix sums
    # over the CURRENT sorted state (ops/bh_window.refresh_lists) — the
    # entries' body ranges are contiguous runs of the frozen sort, so a
    # refresh costs two packed gathers instead of a traversal and zeroes
    # the frozen-advance staleness (the 26% rms τ=48 tail of round 2).
    # With refreshes on, rebuild_interval only bounds the GEOMETRIC decay
    # of the build-time acceptance and can stretch several-fold.
    refresh_interval: int = 0
    # Drift rebuild policy: "max" rebuilds when ANY body moves > skin/2
    # since the last build (strict Verlet safety — one fast core body can
    # force very frequent rebuilds); "off" relies on rebuild_interval
    # alone (frozen entries still advance ballistically; error measured at
    # 0.06%/0.2% of system scale over 48/96 steps at interval 24/48 —
    # tests/test_bh_window.py).  Default "off": the interval bound is the
    # validated production policy.
    rebuild_drift_mode: str = "off"
    use_pallas_eval: bool = True  # fused Pallas per-step evaluation
    # Quadrupole far field (accuracy option): far-list entries carry the
    # traceless second moment.  Measured at 1M galaxy θ=0.8 against a
    # direct-sum oracle (scripts/quad_scan.py): median force error 5.3x
    # better (1.88% -> 0.36%), rms 3.7% -> 3.3%, for +24% rebuild and
    # +20% eval cost.  The p99 tail is set by near-threshold cells where
    # the multipole series converges slowly, so raising the acceptance
    # theta does NOT come free (quad_accept_scale > 1 trades tail error
    # for fewer entries; 1.0 is the calibrated default).  Off by default:
    # the bench-parity target is monopole θ=0.8 (reference
    # nbody/simulation.py:256-258), where speed wins.
    use_quadrupole: bool = False
    quad_accept_scale: float = 0.0
    eval_far_tile: int = 512     # Pallas far-list VMEM tile length
    # Morton groups evaluated per Pallas program: batching amortizes the
    # per-program pipeline overhead (~15 ms across 3907 single-group
    # programs at 1M bodies, measured).
    eval_groups_per_program: int = 4
    # Frozen-entry advance order between rebuilds: 2 stores the per-cell
    # mean acceleration at build and advances entries as
    # com + v·τ + a·τ²/2; 1 is the ballistic advance, whose ½|a|τ² error
    # dominates stale-list force error in high-curvature cores (measured
    # 23% rms at 1M, τ=24 — scripts/staleness_scan.py).  0 = auto: 2 at
    # every scale (the 10-row acc-only far layout keeps the tensor at
    # ~3.2 GB for the 10M EXTREME shape, vs 5.1 GB for the old padded
    # 16-row layout that forced order 1 beyond 4M).
    advance_order: int = 0
    # Curvature horizon (steps) for the quadratic term: past this the
    # frozen acceleration has rotated with the orbit and extrapolating
    # tau^2 overshoots (measured at 1M: better than ballistic to ~tau 30,
    # worse past ~48), so the velocity correction stops growing there.
    advance_tau_clamp: int = 24
    # Global-worklist size budget for the rebuild traversal; overflow
    # degrades entries to bounded-error monopoles/residuals.  Rebuild
    # cost is proportional to the STATIC caps (not the fill), so the
    # budget is sized to measured demand + headroom.
    # 0 = auto: max(256K, 4.2*npad), capped at 6M up to 4.2M bodies,
    # 10M up to 20M, 40M beyond (ops/bh_window._auto_budget).
    worklist_budget: int = 0
    # Explicit per-level worklist capacities (overrides the budget-derived
    # defaults).  The default per-level fractions were measured on the 1M
    # GALAXY profile; isotropic dense distributions (Plummer cluster)
    # demand 2-6x more at the SHALLOW levels, and a clamped shallow level
    # force-emits whole octants as monopoles — measured 10% MEDIAN force
    # error at 100K cluster with every deeper knob (depth, list cap)
    # powerless against it (scripts/decide20.py, round 4).  Set by
    # ops.bh_window.calibrate_config from a demand probe on the actual
    # initial conditions; () = budget-derived defaults.
    wl_caps: tuple = ()
    # Explicit per-level octree slot counts (index level - start_level).
    # The default min(8^d, n) is safe but loose — at 1M bodies the two
    # deepest levels carry ~1M static slots each against 37K/169K
    # occupied cells, and every octree pooling pass and attribute-table
    # pack pays the full static width.  Set by
    # ops.bh_window.calibrate_config from a one-time occupancy count on
    # the actual initial conditions (x2 drift headroom); overflow during
    # a run degrades gracefully to coarser monopole emissions
    # (ops/octree.build_octree), never UB.  () = full capacities.
    tree_caps: tuple = ()
    # Far-list tile-pool compaction (ops/bh_window.build_pool): tile
    # size in entries, 0 = dense (ng, R, L) layout.  The pool stores
    # only ~ceil(far_n/tile) tiles per group — ~4-5x less far HBM and
    # DMA at 1M and the difference between fitting and not at EXTREME
    # scales — and makes moment refreshes ~4x cheaper.  Monopole only
    # (use_quadrupole forces dense); the sharded engine forces dense
    # (its halo eval reads per-device blocks).  Validated on real TPU
    # 2026-08-18 (docs/measurements_r4/decide14_pool.log): the
    # manual-DMA pooled eval compiles and runs at 29.7 ms marginal
    # (dense parity) and the pooled ranges-emission rebuild takes
    # 1757 ms vs ~2.2 s dense at 1M.
    pool_tile: int = 512
    # Static far-pool tile capacity override (0 = derive from the
    # worklist budget / cap sum, ops/bh_window.pool_cap_tiles).  The
    # cap-sum bound is EXACT but wildly pessimistic on grown calibrated
    # caps — at 10M the 53.5M-slot bound made a 3.65 GB pool whose
    # finish transients exhausted HBM (docs/measurements_r5/
    # diag10m.log) while actual stored emissions were ~5x smaller.
    # ops/bh_window.calibrate_config sets this from a counted-emissions
    # probe x1.5 headroom; cumulative overflow beyond it folds whole
    # groups into mass-conserving residuals (bounded error, never UB).
    pool_cap: int = 0
    # Traversal emission mode: "values" scatters every entry's moment
    # columns during traversal (7-10 f32 columns/level); "ranges"
    # scatters only the (start, end) body range (2 int32 columns) and
    # re-materializes moments from prefix sums at finish — with the pool
    # on, straight into the pool, so the dense (ng, R, L) transient
    # never exists (the enabler for pooled EXTREME scales).  "compact"
    # replaces the per-level emission scatters with the scatter-free
    # within-tile compaction + dense assembly ("compact-mm" = the
    # one-hot MXU variant); identical pools, A/B'd on chip in
    # scripts/decide23.py.  "auto" = ranges exactly when the pool is
    # on.  Quadrupole and the sharded (rangeless) build always emit
    # values.  (A Pallas DFS traversal mode "kernel" existed in rounds
    # 3-4; deleted — slower than the XLA path on chip and wrong on real
    # TPU, docs/measurements_r4/decide17_1m.log.)
    traversal_emit: str = "auto"

    # dt cap applied inside the simulation step (reference simulation.py:802).
    max_dt: float = 0.02

    def replace(self, **kw) -> "NBodyConfig":
        return dataclasses.replace(self, **kw)


def resolve_config(config: NBodyConfig, n: int) -> NBodyConfig:
    """Fill the 0-valued auto-tuning fields for a given body count.

    Settings chosen by on-chip scans against a direct-sum force oracle
    (scripts/nbody_error_scan.py): depth 8 at ≤2M bodies both *improves*
    the error tail (fewer worklist/list saturation folds) and cuts the
    rebuild ~40% vs depth 9; group 1024 / list 8192 is the validated 10M
    (EXTREME) shape.  Explicit nonzero fields are left untouched.
    """
    kw = {}
    if config.max_depth == 0:
        # Depth is HBM-bound at the top end: static level capacities are
        # min(8^l, n), so every level past 8 adds an n-sized slab — at
        # 50M, depth 10 is ~6-7 GB of tree alone.  The reference's own
        # EXTREME presets run theta 1.4-1.5 there (coarse acceptance
        # rarely opens past level 8 at ~3 bodies/leaf-cell).
        kw["max_depth"] = 8 if n <= 2_000_000 else (
            9 if n <= 20_000_000 else 8)
    if config.group_size == 0:
        kw["group_size"] = 256 if n <= 4_000_000 else 1024
    if config.list_capacity == 0:
        # >20M is EXTREME territory (reference presets run theta 1.4-1.5
        # there, tools/presets.py:2352-2584): lists are several-fold
        # shorter, and an 8192-cap far tensor would alone exceed HBM at
        # 50M (48828 groups x 10 rows x 8192 x 4 B = 16 GB).
        kw["list_capacity"] = (6144 if n <= 4_000_000 else
                               8192 if n <= 20_000_000 else 2048)
    if config.advance_order == 0:
        # Order 2 stores per-cell mean acceleration: 3 extra far rows
        # AND 6 extra compensated-prefix columns.  At 50M that is
        # ~2.4 GB of HBM for an accuracy term that matters in THETA=0.8
        # cores — the >20M EXTREME ladder runs theta 1.4-1.5 where the
        # acceptance error dominates, so ballistic advance is the right
        # trade there.
        kw["advance_order"] = 2 if n <= 20_500_000 else 1
    if config.pool_tile and n > 20_500_000:
        # The pool's static tile capacity must cover worst-case
        # emissions (overflow folds whole groups to residuals), and a
        # pool tile carries 16 rows vs the dense tensor's 7-10 — at the
        # 50M shape (worklist budget 40M) a safe pool is BIGGER than
        # the dense far tensor.  Dense-from-ranges (no transient) is
        # the memory-optimal layout above 20.5M.
        kw["pool_tile"] = 0
    if config.traversal_emit == "auto" and n > 4_000_000:
        # Values emission holds the scatter columns AND the gathered
        # (ng, R, L) far tensor at once while _finish_lists assembles —
        # ~6.4 GB at the 10M order-2 shape, which is what tipped the 10M
        # bench into RESOURCE_EXHAUSTED in round 4 (the order-2 acc
        # columns and the refresh range columns grew the transient ~2 GB
        # past round 2's peak).  With the pool on, "auto" resolves to
        # cellid emission downstream (bh_window._build_from_sorted);
        # above 20.5M the pool is off (dense-from-ranges is the
        # memory-optimal layout) and ranges emission is required
        # explicitly so the columns never exist.
        if not kw.get("pool_tile", config.pool_tile):
            kw["traversal_emit"] = "ranges"
    return config.replace(**kw) if kw else config


# Module-dict constants kept for parity with the reference UI layers
# (reference config/nbody.py:29-55, 75-78).
WINDOW = {"width": 1280, "height": 720, "title": "N-Body Gravitational Simulation"}

CAMERA = {
    "fov": 75.0,
    "near_clip": 0.1,
    "far_clip": 5000.0,
    "initial_radius": 800.0,
    "initial_theta": 45.0,
    "initial_phi": 35.0,
    "min_radius": -3000.0,
    "max_radius": 3000.0,
    "min_phi": -89.0,
    "max_phi": 89.0,
    "keyboard_rotate_speed": 60.0,
    "keyboard_zoom_speed": 100.0,
    "mouse_sensitivity": 0.3,
}

GRID = {"base_size": 1000, "color": (0.08, 0.08, 0.12)}

NBODY = NBodyConfig()

COLORS = {"background": (0.0, 0.0, 0.02, 1.0), "text": (0.7, 0.8, 0.9)}
