"""Sharded force engines and steps over the bodies axis (port of
``spatialsim_tpu/parallel/sharded.py``).

JAX runs one ``shard_map`` program over the mesh; here every rank runs the
same Python, and each function takes and returns the RANK'S SHARD: ``(3,
n/D)`` positions, ``(n/D,)`` masses, ``(ng/D, R, L)`` far lists.  What JAX
replicates stays whole on every rank: the window engine's
``order``/``inv_order`` and the host counters.  Every rank calls every
collective in the same order, and every branch (rebuild, fallback, refresh)
is decided from values that are equal on all ranks.

* :func:`ring_allpairs_accel`: the O(N^2) path.  Each rank keeps its own
  targets and passes the source block round the ring (D hops),
  accumulating the partial sums in hop order: the blockwise pattern of the
  reference's tiled all-pairs, lifted from shared-memory tiles to
  neighbouring ranks; each hop is kernel 1's targets-and-sources mode.
* :func:`sharded_barnes_hut_accel`: the exact engine.  Every rank gathers
  the bodies, builds the same sorted octree and walks only its own slice
  of Morton groups; one gather of the sorted accelerations gives each rank
  its bodies' results.
* :func:`make_sharded_window_step`: the production engine with its lists
  split by group.  A substep exchanges ``window_groups`` edge groups with
  each neighbour (``2 * wg * gsz * 16`` bytes, whatever N) and evaluates
  the rank's shard with the dense kernel in its ``haloed`` mode; whole-state
  gathers happen only at a rebuild (after the distributed sample sort) and
  a moment refresh.
* :func:`make_sharded_boids_step`: the boids window engine with its
  pass-1-sorted slots split by rank: a halo exchange for pass 1, gathers of
  the 9-row state and the 14 accumulator rows for pass 2, and a replicated
  re-sort every ``resort_interval`` steps.
* :func:`make_sharded_step`: ring or Barnes-Hut, then the integrator.
"""

from __future__ import annotations

from typing import Optional

import torch

from spatialsim_tpu_torch.ops.allpairs import allpairs_accel_at
from spatialsim_tpu_torch.ops.bounds import compute_bounds
from spatialsim_tpu_torch.ops.integrator import integrate
from spatialsim_tpu_torch.ops.morton import morton_encode
from spatialsim_tpu_torch.parallel import distsort
from spatialsim_tpu_torch.parallel.collectives import (
    all_gather, pmax, ring_shift, shift)


def _local(a, mesh):
    """This rank's contiguous block of ``a``'s last axis, on its device."""
    nl = a.shape[-1] // mesh.size
    return a[..., mesh.rank * nl:(mesh.rank + 1) * nl].to(
        mesh.device).contiguous()


def shard_state(state, mesh):
    """This rank's shard of a whole :class:`NBodyState` (original body
    order, any device): columns ``[rank * n/D, (rank + 1) * n/D)`` on the
    rank's device."""
    return type(state)(*(_local(a, mesh) for a in state))


def ring_allpairs_accel(pos, mass, mesh, G, softening):
    """All-pairs accelerations of this rank's bodies over the ring.

    Args:
      pos: ``(3, n/D)`` this rank's positions; mass: ``(n/D,)``.
    Returns:
      ``(3, n/D)`` accelerations of the same bodies.  Hop h adds the block
      of rank ``rank - h``; the four rows (pos, mass) travel together.
      A hop's sum is :func:`allpairs_accel_at` (the local block as
      targets, the visiting block as sources): kernel 1's
      targets-and-sources mode on a card, plain chunks on the CPU.
    """
    acc = torch.zeros_like(pos)
    pos = pos.contiguous()
    pm = torch.cat([pos, mass[None, :]])
    for hop in range(mesh.size):
        acc = acc + allpairs_accel_at(pos, pm[0:3], pm[3], float(G),
                                      float(softening))
        if hop + 1 < mesh.size:
            pm = ring_shift(pm, mesh)
    return acc


def sharded_barnes_hut_accel(pos, mass, mesh, config):
    """Exact Barnes-Hut accelerations of this rank's bodies: the octree of
    the gathered bodies on every rank, the walk over this rank's slice of
    Morton groups (the groups padded up to a multiple of the ranks with
    all-padding groups)."""
    from spatialsim_tpu_torch.config.nbody import resolve_config
    from spatialsim_tpu_torch.ops.barnes_hut import (sorted_tree,
                                                     traverse_range)
    nl = pos.shape[1]
    D = mesh.size
    n = nl * D
    config = resolve_config(config, n)
    gsz = config.group_size
    # Whole groups, rounded up to a multiple of D with all-padding groups.
    n_groups = -(-((n + gsz - 1) // gsz) // D) * D
    gpd = n_groups // D
    pm = all_gather(torch.cat([pos, mass[None, :]]), mesh, axis=1)
    order, s_pos, s_mass, tree = sorted_tree(
        pm[0:3], pm[3], max_depth=config.max_depth, group_size=gsz,
        start_level=2, frontier_cap=config.frontier_capacity,
        npad=n_groups * gsz)
    acc_l = traverse_range(
        s_pos, s_mass, tree, mesh.rank * gpd, (mesh.rank + 1) * gpd,
        theta=config.theta, G=config.G, softening=config.softening,
        leaf_size=config.leaf_size, group_size=gsz,
        frontier_cap=config.frontier_capacity,
        near_ranges=config.near_capacity // config.leaf_size)
    acc_sorted = all_gather(acc_l, mesh, axis=1)
    inv = torch.empty((n,), dtype=torch.int64, device=pos.device)
    inv[order] = torch.arange(n, device=pos.device)
    return acc_sorted[:, inv[mesh.rank * nl:(mesh.rank + 1) * nl]]


def make_sharded_window_step(config, n: int, mesh, substeps: int = 1,
                             cap_factor: float = 2.0):
    """The window engine with its groups (and their lists) split by rank.

    Rank d of D holds the contiguous sorted slot range ``[d n/D, (d+1)
    n/D)`` of the Morton-sorted state and the lists of its ``ng/D`` groups,
    so shards are spatially coherent and a plain substep gathers nothing:

    * the window's cross-shard data is ``window_groups`` edge groups from
      each neighbour (pos and mass in one 4-row exchange a direction; the
      outermost ranks receive zeros, zero mass, as the unsharded eval's
      zero padding);
    * the dense row kernel evaluates the haloed shard
      (:func:`~spatialsim_tpu_torch.ops.bh_eval_kernel.window_eval`,
      ``haloed=True``); its output is this rank's accelerations;
    * a rebuild (``steps_build >= rebuild_interval``, or in drift mode
      "max" a drift past ``skin/2`` anywhere: one max-reduction) sorts with
      :func:`~spatialsim_tpu_torch.parallel.distsort.sample_sort_local`
      (``cap_factor`` its bin capacity), or when a capacity overflowed
      with one sort of the gathered state on every rank; gathers the
      sorted state; and builds this rank's lists from it
      (:func:`~spatialsim_tpu_torch.ops.bh_window.build_lists_sorted`,
      ``group_offset = rank * ng/D``; ``far_range`` holds global slots);
    * a moment refresh (``refresh_interval``) gathers the sorted state and
      refreshes this rank's entries with the unsharded engine's math.

    The lists are dense: ``pool_tile`` and ``near_groups`` are forced to 0
    (a near group may lie outside the halo).  ``n`` must divide into whole
    groups on every rank, and a rank must hold at least ``window_groups``
    groups, so that one exchange covers every window.

    Returns ``(step, init_fn)``: ``step(state, dt)`` takes and returns this
    rank's :class:`~spatialsim_tpu_torch.ops.bh_window.WindowBHState`
    (``order``/``inv_order`` whole, the rest the rank's shard) and counts
    its rebuilds, replicated-sort fallbacks and refreshes in
    ``step.rebuilds``, ``step.fallbacks`` and ``step.refreshes``;
    ``init_fn(pos, vel, mass)`` takes the whole state in original order on
    every rank and returns this rank's state.
    """
    from spatialsim_tpu_torch.config.nbody import resolve_config
    from spatialsim_tpu_torch.ops.bh_eval_kernel import window_eval
    from spatialsim_tpu_torch.ops.bh_window import (
        WindowBHState, _build_kw, _eval_kw, _rebase_coefs,
        _refresh_dense_core, build_lists, build_lists_sorted)
    config = resolve_config(config, n)
    D, rank = mesh.size, mesh.rank
    gsz = config.group_size
    if n % (D * gsz):
        raise ValueError("num_bodies must divide evenly by devices*groups")
    ng = n // gsz
    ngl = ng // D
    nlb = n // D
    wg = config.window_groups
    if wg > ngl:
        raise ValueError(f"window_groups {wg} exceeds the {ngl} groups a "
                         f"rank holds: one neighbour exchange would not "
                         f"cover the window")
    kw = _build_kw(config)
    kw["near_groups"] = 0
    kw["pool_tile"] = 0
    ekw = _eval_kw(config)
    interval = config.rebuild_interval
    refresh_iv = int(getattr(config, "refresh_interval", 0) or 0)
    skin = float(config.skin)
    drift_mode = getattr(config, "rebuild_drift_mode", "max")
    advance2 = getattr(config, "advance_order", 2) >= 2
    halo = wg * gsz
    dev = mesh.device

    def rebuild(state):
        lists = state.lists
        pos_l, vel_l, mass_l = state.pos, state.vel, state.mass
        half = pmax(compute_bounds(pos_l), mesh)
        codes_l = morton_encode(pos_l, half, kw["max_depth"])
        rows = [pos_l, vel_l, mass_l[None, :]]
        if advance2:
            rows.append(state.acc)
        rows = torch.cat(rows)
        prev_slot = (rank * nlb + torch.arange(
            nlb, dtype=torch.int32, device=dev))[None, :]
        _, sf, si, ok = distsort.sample_sort_local(
            codes_l, rows, prev_slot, mesh, cap_factor=cap_factor)
        if ok:
            s_rows = all_gather(sf, mesh, axis=1)
            o = all_gather(si[0], mesh)
        else:
            # A bin overflowed somewhere: every rank sorts the gathered
            # state, as the unsharded rebuild does.
            full = all_gather(rows, mesh, axis=1)
            codes = morton_encode(full[0:3], half, kw["max_depth"])
            o = torch.argsort(codes, stable=True).to(torch.int32)
            s_rows = full[:, o.long()]
            step.fallbacks += 1
        s_pos, s_vel, s_mass = (s_rows[0:3].contiguous(),
                                s_rows[3:6].contiguous(),
                                s_rows[6].contiguous())
        nl = build_lists_sorted(
            s_pos, s_vel, s_mass,
            s_rows[7:10].contiguous() if advance2 else None, order=o,
            group_offset=rank * ngl, n_groups=ngl, **kw)
        o = nl.order.long()                   # new slot -> previous slot
        to_orig = lists.order.long()[o]
        o_inv = torch.empty((n,), dtype=torch.int64, device=dev)
        o_inv[o] = torch.arange(n, device=dev)
        inv_new = o_inv[lists.inv_order.long()]
        mine = slice(rank * nlb, (rank + 1) * nlb)
        pos2 = s_pos[:, mine].contiguous()
        # The halos of the new layout come straight from the gathered,
        # sorted state.
        pm = torch.nn.functional.pad(torch.cat([s_pos, s_mass[None, :]]),
                                     (halo, halo))
        pm_h = pm[:, rank * nlb:rank * nlb + nlb + 2 * halo].contiguous()
        lists = nl._replace(order=to_orig.to(torch.int32),
                            inv_order=inv_new.to(torch.int32),
                            ref_pos=pos2.clone(), steps_since=0,
                            steps_build=0)
        # The step's eval gives the new layout's accelerations.
        state = WindowBHState(pos2, s_vel[:, mine].contiguous(),
                              s_mass[mine].contiguous(), lists, None)
        return state, pm_h

    def refresh(state, dt):
        lists = state.lists
        rows = [state.pos, state.vel, state.mass[None, :]]
        if advance2:
            rows.append(state.acc)
        full = all_gather(torch.cat(rows), mesh, axis=1)
        tau, coef2, tc = _rebase_coefs(lists.steps_since, dt,
                                       ekw["tau_clamp"])
        far = _refresh_dense_core(lists.far, lists.far_range, full[0:3],
                                  full[3:6], full[6],
                                  full[7:10] if advance2 else None, tau,
                                  coef2, tc)
        return lists._replace(far=far, steps_since=0)

    def substep(state, dt):
        lists = state.lists
        need = lists.steps_build >= interval
        if not need and drift_mode == "max":
            drift = (state.pos - lists.ref_pos).abs().amax()
            need = float(pmax(drift, mesh)) > skin * 0.5
        if need:
            state, pm_h = rebuild(state)
            step.rebuilds += 1
        else:
            if refresh_iv and lists.steps_since >= refresh_iv:
                state = state._replace(lists=refresh(state, dt))
                step.refreshes += 1
            pm = torch.cat([state.pos, state.mass[None, :]])
            from_left = shift([pm[:, nlb - halo:]], mesh, +1)[0]
            from_right = shift([pm[:, :halo]], mesh, -1)[0]
            pm_h = torch.cat([from_left, pm, from_right], dim=1)
        lists = state.lists
        acc = window_eval(pm_h[0:3].contiguous(), pm_h[3].contiguous(),
                          lists.far, lists.far_n, None, lists.steps_since,
                          dt, haloed=True, **ekw)
        pos, vel = integrate(state.pos, state.vel, acc, dt, config.damping)
        lists = lists._replace(steps_since=lists.steps_since + 1,
                               steps_build=lists.steps_build + 1)
        return WindowBHState(pos, vel, state.mass, lists,
                             acc if advance2 else None)

    def step(state, dt):
        for _ in range(substeps):
            state = substep(state, float(dt))
        return state

    def init_fn(pos, vel, mass):
        pos, vel, mass = (a.to(dev) for a in (pos, vel, mass))
        acc0 = torch.zeros_like(pos) if advance2 else None
        lists = build_lists(pos, vel, mass, acc0, **kw)
        o = lists.order[:n].long()
        mine = slice(rank * nlb, (rank + 1) * nlb)
        gmine = slice(rank * ngl, (rank + 1) * ngl)
        pos_l = pos[:, o][:, mine].contiguous()
        lists = lists._replace(
            far=lists.far[gmine].contiguous(),
            far_n=lists.far_n[gmine].contiguous(),
            far_range=lists.far_range[gmine].contiguous(),
            ref_pos=pos_l.clone())
        return WindowBHState(pos_l, vel[:, o][:, mine].contiguous(),
                             mass[o][mine].contiguous(), lists,
                             torch.zeros_like(pos_l) if advance2 else None)

    step.rebuilds = 0
    step.fallbacks = 0
    step.refreshes = 0
    return step, init_fn


def make_sharded_boids_step(config, n: int, mesh, substeps: int = 1):
    """The boids window engine with its boids split by rank.

    As the unsharded frozen-order step (``models/boids.py``), with the
    JAX package's collective shapes:

    * the state lives pass-1-Morton-sorted, and rank d holds the sorted
      slots ``[d n/D, (d+1) n/D)``;
    * pass 1: two non-cyclic shifts bring ``window_groups`` edge groups
      of the 9 state rows ``[vel, pos, col]`` from each neighbour; the
      outermost ranks fill the missing halo with far-away slots (pos 2e9,
      vel and col 0), which never pass the perception test.  The window
      kernel evaluates the haloed shard (``haloed=True``);
    * pass 2 (``second_pass``) permutes globally: one ``all_gather`` of the
      9-row state; each rank evaluates its own ``n/D`` pass-2 slots with
      ``pass2_window_groups`` halo groups on each side taken from the
      gathered state (slots past either end far away, group id 1e9), and
      one ``all_gather`` of the 14 accumulator rows brings each rank its
      boids' rows through ``s21``;
    * a re-sort (``steps_since >= resort_interval``, a host counter equal
      on every rank) gathers the state, rebuilds both orders exactly as
      the unsharded step (``build_boids_orders``) and re-slices the shard;
    * merge, steering and physics are elementwise on the shard.

    ``n`` must divide into whole groups on every rank, and a rank must hold
    at least ``window_groups`` groups.  Returns ``(step, init_fn)``:
    ``step(state, dt)`` takes and returns this rank's
    :class:`~spatialsim_tpu_torch.models.boids.BoidsWindowState`
    (pos/vel/col the shard, the orders whole) and counts its re-sorts in
    ``step.resorts``; ``step.pass_inputs(state)`` gives the two passes'
    haloed kernel inputs (a collective call, as a substep makes it);
    ``init_fn(pos, vel, col)`` takes the whole state in original boid order
    on every rank and returns this rank's state.
    """
    import numpy as np

    from spatialsim_tpu_torch.models.boids import (
        _grid_kw, init_boids_window_state, physics_fn)
    from spatialsim_tpu_torch.ops.boids_ops import (
        _inverse, _merge_and_steer, build_boids_orders)
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        boids_window_accumulate)
    D, rank = mesh.size, mesh.rank
    gsz = config.group_size
    if n % (D * gsz):
        raise ValueError("num_boids must divide evenly by devices*groups")
    nl = n // D
    wg = config.window_groups
    wg2 = getattr(config, "pass2_window_groups", 0) or wg
    pw, pw2 = wg * gsz, wg2 * gsz
    if pw > nl:
        raise ValueError(f"window_groups {wg} exceeds the {nl // gsz} "
                         f"groups a rank holds: one neighbour exchange "
                         f"would not cover the window")
    second_pass = config.second_pass
    resort_interval = getattr(config, "resort_interval", 6)
    grid_kw = _grid_kw(config)
    acc_kw = dict(gsz=gsz, perception_sq=config.perception_radius ** 2,
                  separation_sq=config.separation_radius ** 2)
    steer = (config.separation_weight, config.alignment_weight,
             config.cohesion_weight, config.max_speed, config.max_force)
    physics = physics_fn(config)
    dev = mesh.device
    mine = slice(rank * nl, (rank + 1) * nl)
    far9 = torch.cat([torch.zeros((3, pw), device=dev),
                      torch.full((3, pw), 2e9, device=dev),
                      torch.zeros((3, pw), device=dev)])

    def resort(state):
        sf = all_gather(torch.cat([state.pos, state.vel, state.col]), mesh,
                        axis=1)
        o1, p21, s21 = build_boids_orders(sf[0:3], group_size=gsz,
                                          **grid_kw)
        s9 = sf[:, o1[mine]]
        return type(state)(s9[0:3].contiguous(), s9[3:6].contiguous(),
                           s9[6:9].contiguous(), state.order1[o1],
                           _inverse(o1)[state.inv1], p21, s21, 0)

    def pass_inputs(state):
        """``[(args, kw), ...]``: each window pass's haloed kernel input
        (pass 1, then pass 2 with ``second_pass``), after this rank's halo
        exchange and state gather."""
        s9 = torch.cat([state.vel, state.pos, state.col])      # (9, nl)
        from_left = shift([s9[:, nl - pw:]], mesh, +1)[0]
        from_right = shift([s9[:, :pw]], mesh, -1)[0]
        src = torch.cat([from_left if rank > 0 else far9, s9,
                         from_right if rank < D - 1 else far9], dim=1)
        out = [((src[3:6], src[0:3], src[6:9], None),
                dict(wg=wg, haloed=True, **acc_kw))]
        if second_pass:
            sf = all_gather(s9, mesh, axis=1)                   # (9, n)
            k2 = rank * nl + torch.arange(-pw2, nl + pw2, device=dev)
            valid = (k2 >= 0) & (k2 < n)
            p21w = torch.where(valid, state.p21[k2.clamp(0, n - 1)], 0)
            P2 = torch.where(valid, sf[:, p21w], 0.0)
            P2[3:6] = torch.where(valid, P2[3:6], 2e9)
            g1f = torch.where(valid, (p21w // gsz).to(torch.float32), 1e9)
            out.append(((P2[3:6], P2[0:3], P2[6:9], g1f),
                        dict(wg=wg2, prev_wg=wg, haloed=True, **acc_kw)))
        return out

    def substep(state, dt):
        if state.steps_since >= resort_interval:
            state = resort(state)
            step.resorts += 1
        passes = pass_inputs(state)
        rows = boids_window_accumulate(*passes[0][0], **passes[0][1])
        if second_pass:
            acc2 = boids_window_accumulate(*passes[1][0], **passes[1][1])
            rows = rows + all_gather(acc2, mesh, axis=1)[:,
                                                         state.s21[mine]]
        force, avg_col = _merge_and_steer(rows, state.pos, state.vel,
                                          state.col, *steer)
        pos, vel, col = physics(state.pos, state.vel, state.col, force,
                                avg_col, dt)
        return state._replace(pos=pos, vel=vel, col=col,
                              steps_since=state.steps_since + 1)

    def step(state, dt):
        dt = float(np.float32(dt))
        for _ in range(substeps):
            state = substep(state, dt)
        return state

    def init_fn(pos, vel, col):
        st = init_boids_window_state(*(a.to(dev) for a in (pos, vel, col)),
                                     config)
        return st._replace(pos=st.pos[:, mine].contiguous(),
                           vel=st.vel[:, mine].contiguous(),
                           col=st.col[:, mine].contiguous())

    step.resorts = 0
    step.pass_inputs = pass_inputs
    return step, init_fn


def make_sharded_step(config, n: int, mesh, substeps: int = 1,
                      engine: Optional[str] = None):
    """Sharded step ``step(state, dt) -> state`` on this rank's
    :class:`~spatialsim_tpu_torch.models.nbody.NBodyState` shard.

    ``engine``: "allpairs" (the ring) or "barnes_hut"; by default the ring
    up to ``config.allpairs_threshold`` bodies, as the unsharded model
    picks.
    """
    if n % mesh.size:
        raise ValueError("num_bodies must divide evenly across devices")
    if engine is None:
        engine = ("allpairs" if n <= config.allpairs_threshold
                  else "barnes_hut")
    if engine == "allpairs":
        def accel(state):
            return ring_allpairs_accel(state.pos, state.mass, mesh,
                                       config.G, config.softening)
    elif engine == "barnes_hut":
        def accel(state):
            return sharded_barnes_hut_accel(state.pos, state.mass, mesh,
                                            config)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    def step(state, dt):
        for _ in range(substeps):
            acc = accel(state)
            pos, vel = integrate(state.pos, state.vel, acc, float(dt),
                                 config.damping)
            state = type(state)(pos, vel, state.mass)
        return state

    return step
