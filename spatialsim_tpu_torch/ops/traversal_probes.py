"""The traversal-primitive probes of ``scripts/decide15.py`` and
``scripts/decide18.py`` (port of their Pallas microbenchmarks).

A per-group octree traversal kernel stands on a few primitives: random
reads of cell rows from a table held on chip, a reduce whose result comes
back to scalar control flow (the decision word), the append writes, lane
rotates and scalar loads.  The TPU scripts measured each with one small
Pallas kernel; here each is a hand-written CUDA kernel
(``csrc/probes_decide15.cu``, ``csrc/probes_decide18.cu``) that computes
the TPU probe's function -- the same output for the same inputs -- and a
plain PyTorch version beside it.

Four layers, per probe:

* the inputs (``row_inputs``, ``block_read_inputs``, ...) -- made as the
  script makes them (``arange`` tables,
  ``np.random.default_rng(0).integers``); the tools build theirs here too.
* ``bench_*`` / ``probe_*`` -- the TPU probe's name and arguments (plus
  keyword-only extras: ``device``, and the Hopper placements ``chained``
  and ``where``); each runs the wrapper on its inputs and returns the
  kernel's output.  Timing is the caller's job (``tools/decide15.py``,
  ``tools/decide18.py``, ``chip_smoke.py``).
* the wrapper (``row_reads``, ``gated_reduce``, ...) -- takes the inputs;
  a CUDA tensor launches the kernel on the current stream (or raises) and
  adds one to the wrapper's ``launches``; a CPU tensor takes the plain
  version.  5a-5d, 5f-5h and 6a-6d also take ``spread="card"``: the
  same reads, writes or steps cut into ``slices`` contiguous slices, one
  warp each (one thread each for 5f, 5g, 6a and 5h's one-hot variant),
  ``warps`` warps a block, the partials summed in slice order (their
  ``card_launches`` count those calls).
* ``*_reference`` -- the plain version, in the probe's order of
  operations, rounding in float32 and wrapping in int32 as the TPU probe
  and the kernel do (a float32 word goes to int32 toward zero, saturating,
  :func:`_f32_to_i32`), so all three agree bit for bit.  The row sums (5a,
  5b, 5f-5h) are serial float32 scans on the host (:func:`_serial_sum`);
  the chains whose next step depends on the last (5c, 6a, 6b, 6d) go step
  by step, 5c's and 6b's reduces in the kernels' order
  (:func:`_warp_sum`).

Rows 5a-6d refer to the table of TPU kernels in ``PERF.md``.
"""

from __future__ import annotations

import numpy as np
import torch

from spatialsim_tpu_torch import _kernels

ROW = 128                 # float32 lanes of a table row (512 B)
SHARED_ROWS = 448         # the largest table of rows that 227 KB holds
WHERE = ("global", "shared")
WIDTHS = (1, 2, 4, 8)     # row-read chains: decide15's widths
BATCHES = (1, 4, 8)       # reduce round trip: decide15's batches
K_RUNS = (1, 2, 4)        # iteration core: decide18's runs a step
SPREADS = ("warp", "card")  # 5a-5d, 5f-5h, 6a-6d: one warp, or slices
MAX_WARPS = 32            # warps a block of the card-wide instances
ITER_WARPS = 8            # 6d's: K = 4 holds three steps of rows
SMEM_MIN_N = 7            # 6a card-wide: b + acc mod 7 < 2n needs n > 6
SMEM_CARD_BYTES = 16      # 6a card-wide: a block's static shared offsets


# ---- inputs, made as the TPU probes make them ------------------------------

def table(n_cells: int, device="cuda", scale=None) -> torch.Tensor:
    """``arange(n_cells * 128)`` as an ``(n_cells, 128)`` float32 table,
    times ``scale`` in float32 where given (decide18's ``* 1e-6``)."""
    t = torch.arange(n_cells * ROW, dtype=torch.float32,
                     device=device).reshape(n_cells, ROW)
    return t if scale is None else t * scale


def indices(high: int, n: int, device="cuda") -> torch.Tensor:
    """``np.random.default_rng(0).integers(0, high, n)`` as int32."""
    return torch.as_tensor(
        np.random.default_rng(0).integers(0, high, n).astype(np.int32),
        device=device)


def lane_row(device="cuda") -> torch.Tensor:
    """``arange(128)`` as a ``(1, 128)`` float32 row."""
    return torch.arange(ROW, dtype=torch.float32, device=device)[None, :]


def row_inputs(n_cells, n_reads, device="cuda"):
    """5a, 5f, 5g: the table and ``n_reads`` row indices."""
    return table(n_cells, device), indices(n_cells, n_reads, device)


def block_read_inputs(n_cells, n_reads, device="cuda"):
    """5b: the table and first rows in ``[0, n_cells - 2)``."""
    return table(n_cells, device), indices(n_cells - 2, n_reads, device)


def row_write_inputs(n_cells, n_ops, device="cuda"):
    """5d: a table of ones and the rows to write."""
    return (torch.ones((n_cells, ROW), dtype=torch.float32, device=device),
            indices(n_cells, n_ops, device))


def extract8_inputs(n_cells, n_visits, device="cuda"):
    """5h: the table and cell ids in ``[0, 16 n_cells)`` (16 cells of 8
    floats a row)."""
    return table(n_cells, device), indices(n_cells * 16, n_visits, device)


def smem_inputs(device="cuda") -> torch.Tensor:
    """6a: the four run-time offsets, ``arange(4)`` as int32."""
    return torch.arange(4, dtype=torch.int32, device=device)


def smem_edge_inputs(device="cuda") -> torch.Tensor:
    """6a: four offsets near +-2^31.  ``s = idx[i mod 4] + 1009 i`` is
    INT32_MAX at steps 3 and 1,000 and INT32_MAX - 2 at step 201, where
    ``s + acc mod 7`` passes INT32_MAX and the int32 add wraps; past those
    steps s itself wraps to near -2^31, where ``idx[2]`` starts."""
    top = 2 ** 31 - 1
    return torch.tensor([top - 1009 * 1000, top - 2 - 1009 * 201,
                         5 - 2 ** 31, top - 1009 * 3], dtype=torch.int32,
                        device=device)


def smem_optin_bytes(device) -> int:
    """Dynamic shared memory one block may opt in to on ``device``."""
    return int(torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin)


# ---- shared helpers ---------------------------------------------------------

def _i32(x: int) -> int:
    """Wrap a Python int to int32, as the kernels' chains wrap."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _f32_to_i32(x) -> int:
    """A float32 value to int32 as the kernels' ``__float2int_rz`` and
    XLA's convert take it: toward zero, saturating to ``[-2^31, 2^31 -
    1]``, NaN to 0."""
    x = float(x)
    return 0 if x != x else int(max(-2.0 ** 31, min(2.0 ** 31 - 1, x)))


def _lanes(x) -> np.ndarray:
    """A ``(1, 128)`` row as the kernels hold it, host float32 ``(4, 32)``:
    ``[k, l]`` is element ``4 l + k``, component k of lane l's float4."""
    return np.ascontiguousarray(_host(x).reshape(32, 4).T, dtype=np.float32)


def _warp_sum(a) -> np.float32:
    """The kernels' sum of a row held as :func:`_lanes`: each lane's four
    values left to right, then the shuffle butterfly (lanes l and l + o
    added, o = 16, 8, 4, 2, 1), in float32.  Where every partial sum is
    exact in float32 (the probes' rows, and ``arange x 2^24``), any order
    gives these bits, the JAX probe's ``jnp.sum`` included."""
    p = ((a[0] + a[1]) + a[2]) + a[3]
    for o in (16, 8, 4, 2, 1):
        p = p[:o] + p[o:2 * o]
    return p[0]


def _check(name, t, dtype, shape=None):
    if (t.dtype != dtype or (shape is not None and t.shape != shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} "
                         f"{shape or ''}, got {t.dtype} {tuple(t.shape)}, "
                         f"contiguous: {t.is_contiguous()}")


def _on_card(fn_name, x, *others) -> bool:
    """True for CUDA inputs (launch the kernel), False for CPU ones (take
    the plain version); raises on anything else or on mixed devices."""
    if not others and x.is_cuda:
        return True
    dev = x.device
    if all(t.device == dev for t in others):
        if dev.type == "cuda":
            return True
        if dev.type == "cpu":
            return False
    raise ValueError(f"{fn_name}: unsupported devices "
                     f"{[str(t.device) for t in (x, *others)]}")


def _table_args(fn_name, tree, idx):
    _check(f"{fn_name}: tree", tree, torch.float32)
    if tree.dim() != 2 or tree.shape[1] != ROW:
        raise ValueError(f"{fn_name}: tree must be (n_cells, {ROW}), got "
                         f"{tuple(tree.shape)}")
    _check(f"{fn_name}: idx", idx, torch.int32)
    if idx.dim() != 1:
        raise ValueError(f"{fn_name}: idx must be 1-D")


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else t


def _serial_sum(terms, reps=1) -> np.ndarray:
    """``reps`` passes over ``terms`` along axis 0, term after term, each
    add rounded to float32: the order of the kernels' and the TPU probes'
    chains.  numpy's ``add.accumulate`` keeps that order on the host
    (``torch.cumsum`` accumulates in float64): at the scripts' sizes the
    serial float32 sums of ``arange`` rows sit ~1e-4 below the exact ones,
    all rounding one way, because every term of a lane has the same low
    bits."""
    a = np.ascontiguousarray(np.moveaxis(_host(terms), 0, -1),
                             dtype=np.float32)
    acc = np.zeros(a.shape[:-1], np.float32)
    for _ in range(reps):
        acc = np.add.accumulate(np.concatenate([acc[..., None], a], -1),
                                axis=-1)[..., -1]
    return acc


def _check_spread(fn_name, spread, slices, warps, most=MAX_WARPS):
    """Refuse what the one-warp and card-wide instances do not take: a
    ``spread`` not in :data:`SPREADS`; for ``"card"`` a ``slices`` that is
    not a positive int or ``warps`` (1 to ``most``) that does not divide
    it; for ``"warp"`` any ``slices``."""
    if spread not in SPREADS:
        raise ValueError(f"{fn_name}: spread={spread!r} not in {SPREADS}")
    if spread == "warp":
        if slices is not None:
            raise ValueError(f"{fn_name}: slices={slices} is for "
                             f"spread='card' only")
        return
    if (not isinstance(slices, int) or isinstance(slices, bool)
            or slices < 1 or slices > 2 ** 31 - 1):
        raise ValueError(f"{fn_name}: spread='card' needs slices, a "
                         f"positive int, got {slices!r}")
    if (not isinstance(warps, int) or isinstance(warps, bool)
            or not 1 <= warps <= most or slices % warps):
        raise ValueError(f"{fn_name}: warps={warps!r} a block must be in "
                         f"1..{most} and divide slices={slices}")


def slice_bounds(total, slices) -> np.ndarray:
    """Where the card-wide instances cut a stream of ``total`` reads:
    slice p is ``[b[p], b[p + 1])``, ``b[p] = floor(p total / slices)``."""
    return np.arange(slices + 1, dtype=np.int64) * int(total) // slices


def _card_scalar_sum(vals, total, slices):
    """The card-wide order over a stream of ``total`` scalar terms, term
    t ``vals[t mod len(vals)]`` (host float32): each slice summed serially
    from 0, then the slices' partials serially in slice order.  The slices
    are padded to one length with trailing zeros, which leave a float32
    sum that starts at +0 unchanged."""
    b = slice_bounds(total, slices)
    t = b[:-1, None] + np.arange(int(np.diff(b).max()))   # (slices, L)
    live = t < b[1:, None]
    terms = np.zeros(t.shape, np.float32)
    terms[live] = np.asarray(vals, np.float32)[t[live] % max(len(vals), 1)]
    return _serial_sum(_serial_sum(terms.T))


def _card_sum(rows, total, slices, width):
    """The card-wide order over the stream of ``total`` reads whose rows
    ``rows(a, b)`` gives as a host float32 array of ``(n, 128)`` rows, in
    the order they are added (``width`` 1 where a read is several rows):
    slice by slice, row j into accumulator ``j mod width`` (serial
    float32), the accumulators summed left to right, then the slices'
    partials summed serially in slice order."""
    b = slice_bounds(total, slices)
    parts = np.zeros((slices, ROW), np.float32)
    for p in range(slices):
        if b[p + 1] == b[p]:
            continue
        r = rows(int(b[p]), int(b[p + 1]))
        n = r.shape[0]
        full = n // width * width
        acc = (_serial_sum(r[:full].reshape(-1, width, ROW)) if full
               else np.zeros((width, ROW), np.float32))
        for j in range(full, n):                  # the slice's tail
            acc[j - full] = acc[j - full] + r[j]
        s = acc[0]
        for a in acc[1:]:
            s = s + a
        parts[p] = s
    return _serial_sum(parts)


# ---- 5a. row reads (decide15.py:64) -----------------------------------------

def row_reads_reference(tree, idx, reps, width=1):
    """``reps`` passes of ``acc[w] += tree[idx[i width + w]]`` over the
    first ``(n_reads // width) * width`` indices, then ``acc[0] + acc[1] +
    ...``, all in float32, as a ``(1, 128)`` row."""
    steps = idx.shape[0] // width
    rows = _host(tree[idx[:steps * width].long()]).reshape(steps, width, ROW)
    acc = _serial_sum(rows, reps)
    out = acc[0]
    for a in acc[1:]:
        out = out + a
    return torch.from_numpy(out[None, :]).to(tree.device)


def row_reads_card_reference(tree, idx, reps, width=1, slices=1):
    """The card-wide order of :func:`row_reads_reference`'s sum: the
    ``reps`` passes over the first ``(n_reads // width) * width`` indices
    as one stream of reads, cut into ``slices`` contiguous slices
    (:func:`slice_bounds`), each slice summed serially with ``width``
    accumulators, the partials serially in slice order, in float32.
    ``slices=1`` is :func:`row_reads_reference`'s order."""
    used = idx.shape[0] // width * width
    ids, tbl = _host(idx[:used]).astype(np.int64), _host(tree)
    out = _card_sum(lambda a, b: tbl[ids[np.arange(a, b) % used]],
                    reps * used, slices, width)
    return torch.from_numpy(out[None, :]).to(tree.device)


def row_reads(tree, idx, reps, width=1, *, chained=False, where="global",
              spread="warp", slices=None, warps=8):
    """5a through ``csrc/probes_decide15.cu``: ``spread="warp"``, one warp
    with ``width`` independent accumulators (the latency instance);
    ``spread="card"``, ``slices`` warps over the card, ``warps`` a block
    (:func:`row_reads_card_reference`'s order).  ``chained`` makes each
    read wait on the last add; ``where="shared"`` stages the table in
    shared memory first (each block of the card-wide instance stages its
    own) and raises ``ValueError`` before any launch where the card's
    opt-in limit cannot hold it."""
    if width not in WIDTHS:
        raise ValueError(f"row_reads: width {width} not in {WIDTHS}")
    if where not in WHERE:
        raise ValueError(f"row_reads: where={where!r} not in {WHERE}")
    _check_spread("row_reads", spread, slices, warps)
    card = spread == "card"
    if not _on_card("row_reads", tree, idx):
        if card:
            return row_reads_card_reference(tree, idx, reps, width, slices)
        return row_reads_reference(tree, idx, reps, width)
    _table_args("row_reads", tree, idx)
    n_cells = tree.shape[0]
    shared = where == "shared"
    # The card-wide instance keeps its mbarrier in static shared memory.
    need = n_cells * ROW * 4 + (16 if card else 0)
    if shared and need > smem_optin_bytes(tree.device):
        raise ValueError(
            f"row_reads: a {n_cells}-row table ({n_cells * ROW * 4} B) "
            f"exceeds the {smem_optin_bytes(tree.device)} B of shared "
            f"memory a block can opt in to")
    out = torch.empty((1, ROW), dtype=torch.float32, device=tree.device)
    if card:
        partial = torch.empty((slices, ROW), dtype=torch.float32,
                              device=tree.device)
        _kernels.check(_kernels.entry.spatialsim_probe_row_reads_card(
            tree.data_ptr(), idx.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n_cells, idx.shape[0], int(reps), int(width),
            int(chained), int(shared), slices, warps,
            _kernels.stream(tree)), "probe_row_reads_card")
        row_reads.card_launches += 1
    else:
        _kernels.check(_kernels.entry.spatialsim_probe_row_reads(
            tree.data_ptr(), idx.data_ptr(), out.data_ptr(), n_cells,
            idx.shape[0], int(reps), int(width), int(chained), int(shared),
            _kernels.stream(tree)), "probe_row_reads")
    row_reads.launches += 1
    return out


row_reads.launches = 0
row_reads.card_launches = 0


def bench_row_reads(n_cells, n_reads, reps_in_kernel, width=1, *,
                    chained=False, where="global", spread="warp",
                    slices=None, warps=8, device="cuda"):
    """``decide15.bench_row_reads``'s function on this card."""
    return row_reads(*row_inputs(n_cells, n_reads, device), reps_in_kernel,
                     width, chained=chained, where=where, spread=spread,
                     slices=slices, warps=warps)


# ---- 5b. block read (decide15.py:101) ---------------------------------------

def block_read_reference(tree, idx, reps):
    """``acc = (acc + tree[idx[i]]) + tree[idx[i] + 1]`` in float32."""
    i = idx.long()
    rows = _host(torch.stack([tree[i], tree[i + 1]], 1)).reshape(-1, ROW)
    return torch.from_numpy(
        _serial_sum(rows, reps)[None, :]).to(tree.device)


def block_read_card_reference(tree, idx, reps, slices=1):
    """The card-wide order of :func:`block_read_reference`'s sum: the
    ``reps x n_reads`` two-row reads as one stream cut into ``slices``
    (:func:`slice_bounds`), ``acc = (acc + tree[c]) + tree[c + 1]``
    serially in each, the partials serially in slice order."""
    n = idx.shape[0]
    ids, tbl = _host(idx).astype(np.int64), _host(tree)

    def rows(a, b):                     # two rows a read, interleaved
        c = ids[np.arange(a, b) % n]
        return tbl[np.stack([c, c + 1], 1).reshape(-1)]
    return torch.from_numpy(_card_sum(
        rows, reps * n, slices, 1)[None, :]).to(tree.device)


def block_read(tree, idx, reps, *, chained=False, spread="warp",
               slices=None, warps=8):
    """5b: ``sum (tree[idx] + tree[idx + 1])``, one (2, 128) read a step;
    ``spread`` as :func:`row_reads`."""
    _check_spread("block_read", spread, slices, warps)
    card = spread == "card"
    if not _on_card("block_read", tree, idx):
        if card:
            return block_read_card_reference(tree, idx, reps, slices)
        return block_read_reference(tree, idx, reps)
    _table_args("block_read", tree, idx)
    out = torch.empty((1, ROW), dtype=torch.float32, device=tree.device)
    if card:
        partial = torch.empty((slices, ROW), dtype=torch.float32,
                              device=tree.device)
        _kernels.check(_kernels.entry.spatialsim_probe_block_read_card(
            tree.data_ptr(), idx.data_ptr(), partial.data_ptr(),
            out.data_ptr(), idx.shape[0], int(reps), int(chained), slices,
            warps, _kernels.stream(tree)), "probe_block_read_card")
        block_read.card_launches += 1
    else:
        _kernels.check(_kernels.entry.spatialsim_probe_block_read(
            tree.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            int(reps), int(chained), _kernels.stream(tree)),
            "probe_block_read")
    block_read.launches += 1
    return out


block_read.launches = 0
block_read.card_launches = 0


def bench_block_read(n_cells, n_reads, reps_in_kernel, *, chained=False,
                     spread="warp", slices=None, warps=8, device="cuda"):
    return block_read(*block_read_inputs(n_cells, n_reads, device),
                      reps_in_kernel, chained=chained, spread=spread,
                      slices=slices, warps=warps)


def empty_launch(blocks, threads, like):
    """One launch of an empty kernel of ``blocks`` x ``threads`` on the
    current stream of the CUDA tensor ``like``'s device: the launch floor
    beside the card-wide instances' times."""
    if not like.is_cuda:
        raise ValueError(f"empty_launch: {like.device} is not a CUDA device")
    _kernels.check(_kernels.entry.spatialsim_probe_empty(
        int(blocks), int(threads), _kernels.stream(like)), "probe_empty")


# ---- 5c. reduce round trip (decide15.py:143) --------------------------------

def _roundtrip_chain(v, batch, steps, sums) -> np.float32:
    """``steps`` steps of the probe's chain from ``acc = 0`` on the row
    ``v`` (:func:`_lanes`): ``f = 1 + acc * 1e-20``, ``s_b = sum(v * f +
    b)`` (:func:`_warp_sum`), ``acc += s_0 + ... + s_{batch-1}`` in
    float32.  The sums depend on ``acc`` only through ``f``, so ``sums``
    keeps each f's (by its bits) and they are computed once an f."""
    acc = np.float32(0.0)
    for _ in range(steps):
        f = np.float32(np.float32(1.0) + acc * np.float32(1e-20))
        key = int(f.view(np.uint32))
        s = sums.get(key)
        if s is None:
            parts = [_warp_sum(v * f + np.float32(b)) for b in range(batch)]
            s = parts[0]
            for sb in parts[1:]:
                s = np.float32(s + sb)
            sums[key] = s
        acc = np.float32(acc + s)
    return acc


def reduce_roundtrip_reference(x, n_ops, reps, batch=1):
    """The probe's chain over its ``reps x n_ops`` steps
    (:func:`_roundtrip_chain`)."""
    acc = _roundtrip_chain(_lanes(x), batch, max(n_ops, 0) * max(reps, 0), {})
    return torch.tensor([[float(acc)]], dtype=torch.float32, device=x.device)


def reduce_roundtrip_card_reference(x, n_ops, reps, batch=1, slices=1):
    """The card-wide instance's function: the ``reps x n_ops`` steps as one
    stream cut into ``slices`` (:func:`slice_bounds`), each slice's chain
    from ``acc = 0`` (:func:`_roundtrip_chain`), the partials summed
    serially in slice order in float32.  ``slices=1`` is
    :func:`reduce_roundtrip_reference`'s chain."""
    v, sums = _lanes(x), {}
    lens = np.diff(slice_bounds(max(n_ops, 0) * max(reps, 0), slices))
    parts = np.array([_roundtrip_chain(v, batch, int(n), sums)
                      for n in lens], np.float32)
    return torch.tensor([[float(_serial_sum(parts))]], dtype=torch.float32,
                        device=x.device)


def reduce_roundtrip(x, n_ops, reps, batch=1, *, spread="warp", slices=None,
                     warps=8):
    """5c: ``batch`` reductions issued before any is read, then the scalar
    chain; one warp, shuffle butterflies.  ``spread="card"``: the steps cut
    into ``slices``, one warp each, ``warps`` a block, each slice's chain
    from 0, the partials summed in slice order by a second kernel
    (:func:`reduce_roundtrip_card_reference`); ``slices=1`` is the probe's
    chain."""
    if batch not in BATCHES:
        raise ValueError(f"reduce_roundtrip: batch {batch} not in {BATCHES}")
    _check_spread("reduce_roundtrip", spread, slices, warps)
    card = spread == "card"
    if not _on_card("reduce_roundtrip", x):
        if card:
            return reduce_roundtrip_card_reference(x, n_ops, reps, batch,
                                                   slices)
        return reduce_roundtrip_reference(x, n_ops, reps, batch)
    _check("reduce_roundtrip: x", x, torch.float32, (1, ROW))
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    if card:
        partial = torch.empty(slices, dtype=torch.float32, device=x.device)
        _kernels.check(_kernels.entry.spatialsim_probe_reduce_roundtrip_card(
            x.data_ptr(), partial.data_ptr(), out.data_ptr(), int(n_ops),
            int(reps), int(batch), slices, warps, _kernels.stream(x)),
            "probe_reduce_roundtrip_card")
        reduce_roundtrip.card_launches += 1
    else:
        _kernels.check(_kernels.entry.spatialsim_probe_reduce_roundtrip(
            x.data_ptr(), out.data_ptr(), int(n_ops), int(reps), int(batch),
            _kernels.stream(x)), "probe_reduce_roundtrip")
    reduce_roundtrip.launches += 1
    return out


reduce_roundtrip.launches = 0
reduce_roundtrip.card_launches = 0


def bench_reduce_roundtrip(n_ops, reps_in_kernel, batch=1, *, spread="warp",
                           slices=None, warps=8, device="cuda"):
    return reduce_roundtrip(lane_row(device), n_ops, reps_in_kernel, batch,
                            spread=spread, slices=slices, warps=warps)


# ---- 5d. row write (decide15.py:177) ----------------------------------------

def row_write_reference(tree, idx, reps):
    scr = torch.zeros_like(tree)
    i = idx.long()
    scr[i] = tree[i] * 2.0
    return scr[0:1].clone(), scr


def row_write_card_reference(tree, idx, reps, slices=1):
    """The card-wide instance's function: every write carries the same
    bits whichever slice makes it, so the table, and ``scr[0]`` read after
    every write, are :func:`row_write_reference`'s at any ``slices``."""
    return row_write_reference(tree, idx, reps)


def row_write(tree, idx, reps, *, spread="warp", slices=None, warps=8):
    """5d: ``scr[idx[i]] = 2 * tree[idx[i]]`` into a zeroed scratch table;
    returns ``(scr[0], scr)``: the probe's output, and the table, which
    holds every write (row 0 is written only where some index is 0).
    ``spread="card"``: the ``reps x n_ops`` writes cut into ``slices``, one
    warp each, ``warps`` a block; ``scr[0]`` read by a second launch."""
    _check_spread("row_write", spread, slices, warps)
    card = spread == "card"
    if not _on_card("row_write", tree, idx):
        if card:
            return row_write_card_reference(tree, idx, reps, slices)
        return row_write_reference(tree, idx, reps)
    _table_args("row_write", tree, idx)
    scr = torch.zeros_like(tree)
    out = torch.empty((1, ROW), dtype=torch.float32, device=tree.device)
    if card:
        _kernels.check(_kernels.entry.spatialsim_probe_row_write_card(
            tree.data_ptr(), idx.data_ptr(), scr.data_ptr(), out.data_ptr(),
            idx.shape[0], int(reps), slices, warps, _kernels.stream(tree)),
            "probe_row_write_card")
        row_write.card_launches += 1
    else:
        _kernels.check(_kernels.entry.spatialsim_probe_row_write(
            tree.data_ptr(), idx.data_ptr(), scr.data_ptr(), out.data_ptr(),
            idx.shape[0], int(reps), _kernels.stream(tree)),
            "probe_row_write")
    row_write.launches += 1
    return out, scr


row_write.launches = 0
row_write.card_launches = 0


def bench_row_write(n_cells, n_ops, reps_in_kernel, *, spread="warp",
                    slices=None, warps=8, device="cuda"):
    return row_write(*row_write_inputs(n_cells, n_ops, device),
                     reps_in_kernel, spread=spread, slices=slices,
                     warps=warps)


# ---- 5e. roll (decide15.py:206) ---------------------------------------------

def roll_reference(x, shift):
    return torch.roll(x, int(shift), 1)


_ROW_SHAPE = (1, ROW)


def roll(x, shift):
    """5e: ``torch.roll(x, shift, 1)`` of a (1, 128) row, the shift a
    run-time argument: register selects and one shuffle per component.
    Its kernel runs ~1 us, so its launch path is what a call costs: the
    checks are inlined on the card's path."""
    if not x.is_cuda:
        _on_card("roll", x)                    # the CPU, or raises
        return roll_reference(x, shift)
    if (x.dtype is not torch.float32 or x.shape != _ROW_SHAPE
            or not x.is_contiguous()):
        _check("roll: x", x, torch.float32, _ROW_SHAPE)
    out = torch.empty_like(x)
    err = _kernels.entry.spatialsim_probe_roll(
        x.data_ptr(), int(shift), out.data_ptr(), _kernels.stream(x))
    if err:
        _kernels.fail(err, "probe_roll")
    roll.launches += 1
    return out


roll.launches = 0


def bench_roll(*, device="cuda"):
    return roll(lane_row(device), 5)


# ---- 5f, 5g. scalar loads (decide15.py:239, 272) ----------------------------

def _scalar_sum(vals, reps, device):
    """``reps`` passes of ``acc += vals[i]`` in float32, as ``(1, 1)``."""
    return torch.tensor([[float(_serial_sum(vals, reps))]],
                        dtype=torch.float32, device=device)


def _scalar_vals(tree, idx, dyn_lane):
    """Each read's value: ``tree[c, 5]``, or ``tree[c, (7 c) mod 128]``
    with ``dyn_lane``; c = idx[i]."""
    i = idx.long()
    return tree[i, (i * 7) % ROW] if dyn_lane else tree[i, 5]


def scalar_load_dynsub_reference(tree, idx, reps):
    return _scalar_sum(_scalar_vals(tree, idx, False), reps, tree.device)


def scalar_load_dyn_dyn_reference(tree, idx, reps):
    return _scalar_sum(_scalar_vals(tree, idx, True), reps, tree.device)


def scalar_load_card_reference(tree, idx, reps, slices=1, dyn_lane=False):
    """The card-wide order of 5f's (5g's with ``dyn_lane``) sum: the
    ``reps x n_reads`` reads as one stream cut into ``slices``
    (:func:`slice_bounds`), each slice's values added serially from 0, the
    partials serially in slice order, in float32.  ``slices=1`` is the
    serial plain version's order."""
    out = _card_scalar_sum(_host(_scalar_vals(tree, idx, dyn_lane)),
                           reps * idx.shape[0], slices)
    return torch.tensor([[float(out)]], dtype=torch.float32,
                        device=tree.device)


def _scalar_load(counter, dyn_lane, tree, idx, reps, chained, spread,
                 slices, warps):
    name = counter.__name__
    _check_spread(name, spread, slices, warps)
    card = spread == "card"
    if not _on_card(name, tree, idx):
        if card:
            return scalar_load_card_reference(tree, idx, reps, slices,
                                              dyn_lane)
        ref = (scalar_load_dyn_dyn_reference if dyn_lane
               else scalar_load_dynsub_reference)
        return ref(tree, idx, reps)
    _table_args(name, tree, idx)
    out = torch.empty((1, 1), dtype=torch.float32, device=tree.device)
    if card:
        partial = torch.empty(slices, dtype=torch.float32,
                              device=tree.device)
        _kernels.check(_kernels.entry.spatialsim_probe_scalar_load_card(
            tree.data_ptr(), idx.data_ptr(), partial.data_ptr(),
            out.data_ptr(), idx.shape[0], int(reps), int(dyn_lane),
            int(chained), slices, warps, _kernels.stream(tree)),
            f"probe_{name}_card")
        counter.card_launches += 1
    else:
        _kernels.check(_kernels.entry.spatialsim_probe_scalar_load(
            tree.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            int(reps), int(dyn_lane), int(chained), _kernels.stream(tree)),
            f"probe_{name}")
    counter.launches += 1
    return out


def scalar_load_dynsub(tree, idx, reps, *, chained=False, spread="warp",
                       slices=None, warps=8):
    """5f: ``sum tree[idx[i], 5]``.  ``spread="warp"`` (the name the six
    card-wide probes share) is one thread, a serial chain;
    ``spread="card"``: the reads cut into ``slices``, one thread each, 32
    ``warps`` threads a block, the partials summed in slice order by a
    second kernel (:func:`scalar_load_card_reference`'s order)."""
    return _scalar_load(scalar_load_dynsub, False, tree, idx, reps, chained,
                        spread, slices, warps)


def scalar_load_dyn_dyn(tree, idx, reps, *, chained=False, spread="warp",
                        slices=None, warps=8):
    """5g: ``sum tree[c, (7 c) mod 128]``, c = idx[i]; the spreads as
    :func:`scalar_load_dynsub`'s."""
    return _scalar_load(scalar_load_dyn_dyn, True, tree, idx, reps, chained,
                        spread, slices, warps)


scalar_load_dynsub.launches = 0
scalar_load_dynsub.card_launches = 0
scalar_load_dyn_dyn.launches = 0
scalar_load_dyn_dyn.card_launches = 0


def probe_scalar_load_dynsub(n_cells=8192, n_reads=4096, reps=20, *,
                             chained=False, spread="warp", slices=None,
                             warps=8, device="cuda"):
    return scalar_load_dynsub(*row_inputs(n_cells, n_reads, device), reps,
                              chained=chained, spread=spread, slices=slices,
                              warps=warps)


def probe_scalar_load_dyn_dyn_retry(n_cells=8192, n_reads=4096, reps=20, *,
                                    chained=False, spread="warp",
                                    slices=None, warps=8, device="cuda"):
    return scalar_load_dyn_dyn(*row_inputs(n_cells, n_reads, device), reps,
                               chained=chained, spread=spread, slices=slices,
                               warps=warps)


# ---- 5h. extract8 (decide15.py:325) -----------------------------------------

def _visit_sums(tree, idx) -> np.ndarray:
    """Each visit's 8 floats ``tree[c // 16, (c % 16) 8 + k]``, c =
    idx[i], summed in the probe's order, as host float32."""
    c = idx.long()
    cols = ((c % 16) * 8)[:, None] + torch.arange(8, device=c.device)
    return _serial_sum(tree[(c // 16)[:, None], cols].T)  # (n_visits,)


def extract8_reference(tree, idx, reps):
    """Both variants: ``sum over visits and k < 8 of
    tree[c // 16, (c % 16) 8 + k]``, c = idx[i]."""
    return _scalar_sum(_visit_sums(tree, idx), reps, tree.device)


def extract8_card_reference(tree, idx, reps, slices=1):
    """The card-wide order of :func:`extract8_reference`'s sum (both
    variants): the ``reps x n_visits`` visits as one stream cut into
    ``slices`` (:func:`slice_bounds`), each slice's visit sums added
    serially from 0, the partials serially in slice order, in float32.
    ``slices=1`` is :func:`extract8_reference`'s order."""
    out = _card_scalar_sum(_visit_sums(tree, idx), reps * idx.shape[0],
                           slices)
    return torch.tensor([[float(out)]], dtype=torch.float32,
                        device=tree.device)


def extract8(tree, idx, reps, *, use_roll=True, chained=False,
             spread="warp", slices=None, warps=8):
    """5h: one thread's two 16 B loads (``use_roll=False``) or the warp's
    row read, shuffle alignment and shuffle sum (``use_roll=True``); both
    give the same bits.  ``spread="card"``: the visits cut into ``slices``,
    one warp each (``use_roll``) or one thread each (32 ``warps`` threads
    a block), the partials summed in slice order by a second kernel
    (:func:`extract8_card_reference`'s order)."""
    _check_spread("extract8", spread, slices, warps)
    card = spread == "card"
    if not _on_card("extract8", tree, idx):
        if card:
            return extract8_card_reference(tree, idx, reps, slices)
        return extract8_reference(tree, idx, reps)
    _table_args("extract8", tree, idx)
    out = torch.empty((1, 1), dtype=torch.float32, device=tree.device)
    if card:
        partial = torch.empty(slices, dtype=torch.float32,
                              device=tree.device)
        _kernels.check(_kernels.entry.spatialsim_probe_extract8_card(
            tree.data_ptr(), idx.data_ptr(), partial.data_ptr(),
            out.data_ptr(), idx.shape[0], int(reps), int(use_roll),
            int(chained), slices, warps, _kernels.stream(tree)),
            "probe_extract8_card")
        extract8.card_launches += 1
    else:
        _kernels.check(_kernels.entry.spatialsim_probe_extract8(
            tree.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            int(reps), int(use_roll), int(chained), _kernels.stream(tree)),
            "probe_extract8")
    extract8.launches += 1
    return out


extract8.launches = 0
extract8.card_launches = 0


def bench_extract8(n_cells=8192, n_visits=4096, reps=10, use_roll=True, *,
                   chained=False, spread="warp", slices=None, warps=8,
                   device="cuda"):
    return extract8(*extract8_inputs(n_cells, n_visits, device), reps,
                    use_roll=use_roll, chained=chained, spread=spread,
                    slices=slices, warps=warps)


# ---- 6a. table in on-chip memory (decide18.py:60) ---------------------------

def _smem_chain(tbl, ids, n_ops, t0, steps) -> int:
    """``steps`` steps of the probe's int32 chain from ``acc = 0`` on the
    table ``tbl`` (a list of n ints), from step ``t0`` of the stream (step
    t at ``i = t mod n_ops``): ``acc += tbl[(idx[i mod 4] + 1009 i + acc
    mod 7) mod n]``, each add wrapped to int32, ``%`` the floor modulo."""
    n, acc, i = len(tbl), 0, t0 % n_ops if n_ops else 0
    for _ in range(steps):
        acc = _i32(acc + tbl[_i32(_i32(ids[i % 4] + i * 1009) + acc % 7)
                             % n])
        i = 0 if i + 1 == n_ops else i + 1
    return acc


def _smem_tables(idx4, n_i32):
    """The probe's table, ``tbl[997 i mod n] = i`` (i < 256, the last
    write winning) over zeros, and the four offsets as Python ints."""
    tbl = [0] * n_i32
    for i in range(256):
        tbl[(i * 997) % n_i32] = i
    return tbl, [int(v) for v in idx4.tolist()]


def smem_table_reference(idx4, n_i32, n_ops=4096, reps=20):
    """Step by step in int32 over the probe's table: ``acc +=
    tbl[(idx[i mod 4] + 1009 i + acc mod 7) mod n]`` (:func:`_smem_chain`)
    for ``reps`` passes of ``n_ops`` steps."""
    acc = _smem_chain(*_smem_tables(idx4, n_i32), n_ops, 0,
                      max(n_ops, 0) * max(reps, 0))
    return torch.tensor([[acc]], dtype=torch.int32, device=idx4.device)


def smem_table_card_reference(idx4, n_i32, n_ops=4096, reps=20, slices=1):
    """The card-wide instance's function: the ``reps x n_ops`` steps as one
    stream cut into ``slices`` (:func:`slice_bounds`), each slice's chain
    from ``acc = 0`` (:func:`_smem_chain`), the results added with int32
    wrap.  ``slices=1`` is :func:`smem_table_reference`'s chain."""
    tbl, ids = _smem_tables(idx4, n_i32)
    b = slice_bounds(max(n_ops, 0) * max(reps, 0), slices)
    out = 0
    for p in range(slices):
        out = _i32(out + _smem_chain(tbl, ids, n_ops, int(b[p]),
                                     int(b[p + 1] - b[p])))
    return torch.tensor([[out]], dtype=torch.int32, device=idx4.device)


def smem_table(idx4, n_i32, n_ops=4096, reps=20, *, where="shared",
               spread="warp", slices=None, warps=1):
    """6a: the table in dynamic shared memory (``where="shared"``; raises
    ``ValueError`` before any launch where the table, and the card-wide
    kernel's 16 B of offsets, exceed the card's opt-in limit) or in device
    memory (``"global"``).  ``spread="warp"`` is one thread, the probe's
    chain; ``spread="card"``: the steps cut into ``slices``, one thread
    each, 32 ``warps`` threads a block, each block's own table in shared
    memory (or one in device memory), each slice's chain from 0 with the
    modulo by n taken off the chain, the results added by a second kernel
    (:func:`smem_table_card_reference`); ``slices=1`` is the probe's
    chain.  The card-wide instance takes ``SMEM_MIN_N <= n_i32 < 2^31``."""
    if where not in WHERE:
        raise ValueError(f"smem_table: where={where!r} not in {WHERE}")
    _check_spread("smem_table", spread, slices, warps)
    card = spread == "card"
    if card and not SMEM_MIN_N <= n_i32 <= 2 ** 31 - 1:
        raise ValueError(f"smem_table: spread='card' takes {SMEM_MIN_N} <= "
                         f"n_i32 < 2^31, got {n_i32}")
    if not _on_card("smem_table", idx4):
        if card:
            return smem_table_card_reference(idx4, n_i32, n_ops, reps,
                                             slices)
        return smem_table_reference(idx4, n_i32, n_ops, reps)
    _check("smem_table: idx4", idx4, torch.int32, (4,))
    shared = where == "shared"
    need = 4 * n_i32 + (SMEM_CARD_BYTES if card else 0)
    if shared and need > smem_optin_bytes(idx4.device):
        raise ValueError(
            f"smem_table: a {need} B block exceeds the "
            f"{smem_optin_bytes(idx4.device)} B of shared memory a block "
            f"can opt in to")
    out = torch.empty((1, 1), dtype=torch.int32, device=idx4.device)
    if card:
        # The entry point zeroes a device-memory table itself.
        gtable = torch.empty(0 if shared else n_i32, dtype=torch.int32,
                             device=idx4.device)
        partial = torch.empty(slices, dtype=torch.int32, device=idx4.device)
        _kernels.check(_kernels.entry.spatialsim_probe_smem_table_card(
            idx4.data_ptr(), gtable.data_ptr(), partial.data_ptr(),
            out.data_ptr(), int(n_i32), int(n_ops), int(reps), int(shared),
            slices, warps, _kernels.stream(idx4)), "probe_smem_table_card")
        smem_table.card_launches += 1
    else:
        gtable = torch.zeros(0 if shared else n_i32, dtype=torch.int32,
                             device=idx4.device)
        _kernels.check(_kernels.entry.spatialsim_probe_smem_table(
            idx4.data_ptr(), gtable.data_ptr(), out.data_ptr(), int(n_i32),
            int(n_ops), int(reps), int(shared), _kernels.stream(idx4)),
            "probe_smem_table")
    smem_table.launches += 1
    return out


smem_table.launches = 0
smem_table.card_launches = 0


def probe_smem_capacity(n_i32, *, where="shared", n_ops=4096, reps=20,
                        spread="warp", slices=None, warps=1, device="cuda"):
    return smem_table(smem_inputs(device), n_i32, n_ops, reps, where=where,
                      spread=spread, slices=slices, warps=warps)


# ---- 6b. gated reduce (decide18.py:99) --------------------------------------

def _gated_chain(v, pct, n_ops, t0, steps, words) -> int:
    """``steps`` steps of the probe's int32 chain from ``acc = 0`` on the
    row ``v`` (:func:`_lanes`), from step ``t0`` of the stream (step t at
    ``i = t mod n_ops``): ``t = acc * 1e-20`` (float32), ``w = int(sum(v
    + t))``, a hit when ``(w + i) mod 100 < pct``, then ``acc += w + (hit
    ? int(sum(2 v + t)) : 0)``, each sum :func:`_warp_sum`, each word
    converted by :func:`_f32_to_i32`.  The words depend on ``acc`` only
    through ``t``: ``words`` keeps each t's (by its bits)."""
    acc, i = 0, t0 % n_ops if n_ops else 0
    v2 = v * np.float32(2.0)
    for _ in range(steps):
        t = np.float32(np.float32(acc) * np.float32(1e-20))
        key = int(t.view(np.uint32))
        w = words.get((key, 1))
        if w is None:
            w = words[key, 1] = _f32_to_i32(_warp_sum(v + t))
        add = 0
        if _i32(w + i) % 100 < pct:
            add = words.get((key, 2))
            if add is None:
                add = words[key, 2] = _f32_to_i32(_warp_sum(v2 + t))
        acc = _i32(_i32(acc + w) + add)
        i = 0 if i + 1 == n_ops else i + 1
    return acc


def gated_reduce_reference(x, gate_frac_pct, n_ops=4096, reps=20):
    """The probe's chain over its ``reps x n_ops`` steps
    (:func:`_gated_chain`)."""
    acc = _gated_chain(_lanes(x), gate_frac_pct, n_ops, 0,
                       max(n_ops, 0) * max(reps, 0), {})
    return torch.tensor([[acc]], dtype=torch.int32, device=x.device)


def gated_reduce_card_reference(x, gate_frac_pct, n_ops=4096, reps=20,
                                slices=1):
    """The card-wide instance's function: the ``reps x n_ops`` steps as one
    stream cut into ``slices`` (:func:`slice_bounds`), each slice's chain
    from ``acc = 0`` (:func:`_gated_chain`), the results added with int32
    wrap.  ``slices=1`` is :func:`gated_reduce_reference`'s chain."""
    v, words = _lanes(x), {}
    b = slice_bounds(max(n_ops, 0) * max(reps, 0), slices)
    out = 0
    for p in range(slices):
        out = _i32(out + _gated_chain(v, gate_frac_pct, n_ops, int(b[p]),
                                      int(b[p + 1] - b[p]), words))
    return torch.tensor([[out]], dtype=torch.int32, device=x.device)


def gated_reduce(x, gate_frac_pct, n_ops=4096, reps=20, *, spread="warp",
                 slices=None, warps=8):
    """6b: the word reduce every step and a second reduce on a hit; one
    warp, the branch uniform across it.  ``spread="card"``: the steps cut
    into ``slices``, one warp each, ``warps`` a block, each slice's chain
    from 0 with the second reduce issued beside the first on every step
    and taken by a select, the results added by a second kernel
    (:func:`gated_reduce_card_reference`); ``slices=1`` is the probe's
    chain."""
    _check_spread("gated_reduce", spread, slices, warps)
    card = spread == "card"
    if not _on_card("gated_reduce", x):
        if card:
            return gated_reduce_card_reference(x, gate_frac_pct, n_ops, reps,
                                               slices)
        return gated_reduce_reference(x, gate_frac_pct, n_ops, reps)
    _check("gated_reduce: x", x, torch.float32, (1, ROW))
    out = torch.empty((1, 1), dtype=torch.int32, device=x.device)
    if card:
        partial = torch.empty(slices, dtype=torch.int32, device=x.device)
        _kernels.check(_kernels.entry.spatialsim_probe_gated_reduce_card(
            x.data_ptr(), partial.data_ptr(), out.data_ptr(),
            int(gate_frac_pct), int(n_ops), int(reps), slices, warps,
            _kernels.stream(x)), "probe_gated_reduce_card")
        gated_reduce.card_launches += 1
    else:
        _kernels.check(_kernels.entry.spatialsim_probe_gated_reduce(
            x.data_ptr(), out.data_ptr(), int(gate_frac_pct), int(n_ops),
            int(reps), _kernels.stream(x)), "probe_gated_reduce")
    gated_reduce.launches += 1
    return out


gated_reduce.launches = 0
gated_reduce.card_launches = 0


def probe_gated_reduce(gate_frac_pct, *, n_ops=4096, reps=20, spread="warp",
                       slices=None, warps=8, device="cuda"):
    return gated_reduce(lane_row(device), gate_frac_pct, n_ops, reps,
                        spread=spread, slices=slices, warps=warps)


# ---- 6c. row store (decide18.py:135) ----------------------------------------

def row_store_reference(idx, n_cells, reps=20):
    """``scr[idx[i]] = iota + i`` over a zeroed table, the last i winning
    (no store at ``reps`` 0); returns ``(scr[0], scr)``."""
    i = idx.long()[:idx.shape[0] if reps > 0 else 0]
    last = torch.full((n_cells,), -1, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, i, torch.arange(i.shape[0], device=idx.device),
                         "amax")
    scr = torch.zeros((n_cells, ROW), dtype=torch.float32, device=idx.device)
    hit = last >= 0
    scr[hit] = (torch.arange(ROW, dtype=torch.float32, device=idx.device)
                + last[hit, None].float())
    return scr[0:1].clone(), scr


def row_store_card_reference(idx, n_cells, reps=20, slices=1):
    """The card-wide instance's two passes: ``last[r]``, the largest i
    with ``idx[i] = r`` (-1 elsewhere), then the ``reps x n_ops`` stores
    as one stream (cut into ``slices``), store t to ``r = idx[t mod
    n_ops]`` with ``iota + last[r]``.  Every store to a row carries its
    last writer's bits, so the table is :func:`row_store_reference`'s in
    any order of the stores, at any ``slices``."""
    ids = _host(idx).astype(np.int64)
    n = ids.shape[0]
    last = np.full(n_cells, -1, np.int64)
    np.maximum.at(last, ids, np.arange(n))
    scr = np.zeros((n_cells, ROW), np.float32)
    rows = ids[np.arange(reps * n) % max(n, 1)]
    scr[rows] = (np.arange(ROW, dtype=np.float32)
                 + last[rows, None].astype(np.float32))
    scr = torch.from_numpy(scr).to(idx.device)
    return scr[0:1].clone(), scr


def row_store(idx, n_cells, reps=20, *, spread="warp", slices=None,
              warps=8):
    """6c: a 512 B row store a step into a zeroed scratch table; returns
    ``(scr[0], scr)`` as :func:`row_write`.  ``spread="card"``: a
    last-writer pass (``atomicMax``), then the ``reps x n_ops`` stores cut
    into ``slices``, one warp each, ``warps`` a block, each store writing
    its row's last writer's bits; ``scr[0]`` read by a third launch."""
    _check_spread("row_store", spread, slices, warps)
    card = spread == "card"
    if n_cells < 1:
        raise ValueError(f"row_store: n_cells {n_cells} < 1")
    if not _on_card("row_store", idx):
        if card:
            return row_store_card_reference(idx, n_cells, reps, slices)
        return row_store_reference(idx, n_cells, reps)
    _check("row_store: idx", idx, torch.int32)
    scr = torch.zeros((n_cells, ROW), dtype=torch.float32, device=idx.device)
    out = torch.empty((1, ROW), dtype=torch.float32, device=idx.device)
    if card:
        last = torch.empty(n_cells, dtype=torch.int32, device=idx.device)
        _kernels.check(_kernels.entry.spatialsim_probe_row_store_card(
            idx.data_ptr(), last.data_ptr(), scr.data_ptr(), out.data_ptr(),
            int(n_cells), idx.shape[0], int(reps), slices, warps,
            _kernels.stream(idx)), "probe_row_store_card")
        row_store.card_launches += 1
    else:
        _kernels.check(_kernels.entry.spatialsim_probe_row_store(
            idx.data_ptr(), scr.data_ptr(), out.data_ptr(), idx.shape[0],
            int(reps), _kernels.stream(idx)), "probe_row_store")
    row_store.launches += 1
    return out, scr


row_store.launches = 0
row_store.card_launches = 0


def probe_row_store(n_cells, *, n_ops=4096, reps=20, spread="warp",
                    slices=None, warps=8, device="cuda"):
    return row_store(indices(n_cells, n_ops, device), n_cells, reps,
                     spread=spread, slices=slices, warps=warps)


# ---- 6d. iteration core (decide18.py:198) -----------------------------------

def decision_words(tree, s):
    """The decision word of a run at each start ``s`` (int64 tensor): the
    probe's alignment, shifts, opening test and weighted sum, over all
    starts at once."""
    n_cells = tree.shape[0]
    row = torch.div(s, 16, rounding_mode="floor") % (n_cells - 2)
    base8 = (s % 16) * 8
    flat = torch.cat([tree[row], tree[row + 1]], 1)          # (m, 256)
    lanes = torch.arange(ROW, device=tree.device)
    al = flat.gather(1, base8[:, None] + lanes)
    bsv, bev, cxv = (torch.roll(al, k, 1) for k in (126, 125, 124))
    gx = torch.maximum(1.0 - cxv, cxv - 2.0)
    dmin = gx * gx + 1.0
    accept = (al < 0.64 * dmin) | (bev - bsv <= 1.0)
    em = (bev > bsv) & accept & (bsv > 100.0)
    weights = 4 ** torch.arange(8, device=tree.device)
    return (em[:, 0:64:8].long() * weights).sum(1)


def _iteration_chain(tree, idx, k_runs, n_iters, reps, slices=1):
    """The int32 chains ``acc += word(idx[i k + q] + acc mod 3) mod 5``
    over the ``reps x n_iters`` steps as one stream (step t at ``i = t mod
    n_iters``) cut into ``slices`` (:func:`slice_bounds`), each from
    ``acc = 0``, with the words of every reachable start computed first
    (:func:`decision_words`); returns the slices' ``acc`` and the starts
    they took.  One slice is the probe's chain."""
    b = slice_bounds(reps * n_iters, slices)
    if not reps * n_iters:
        return [0] * slices, set()
    ids = [int(v) for v in idx.tolist()]
    lo, hi = min(ids), max(ids) + 2
    words = decision_words(
        tree, torch.arange(lo, hi + 1, device=tree.device)).tolist()
    accs, starts = [], set()
    for p in range(slices):
        acc = 0
        for t in range(int(b[p]), int(b[p + 1])):
            i = t % n_iters
            a3 = acc % 3
            add = 0
            for q in range(k_runs):
                s = _i32(ids[i * k_runs + q] + a3)
                starts.add(s)
                add = _i32(add + words[s - lo] % 5)
            acc = _i32(acc + add)
        accs.append(acc)
    return accs, starts


def iteration_core_reference(tree, idx, k_runs, n_iters=2048, reps=10):
    (acc,), _ = _iteration_chain(tree, idx, k_runs, n_iters, reps)
    return torch.tensor([[acc]], dtype=torch.int32, device=tree.device)


def iteration_core_card_reference(tree, idx, k_runs, n_iters=2048, reps=10,
                                  slices=1):
    """The card-wide instance's function: the steps cut into ``slices``,
    each slice's chain from ``acc = 0`` (:func:`_iteration_chain`), their
    results added with int32 wrap.  ``slices=1`` is
    :func:`iteration_core_reference`'s."""
    accs, _ = _iteration_chain(tree, idx, k_runs, n_iters, reps, slices)
    out = 0
    for a in accs:
        out = _i32(out + a)
    return torch.tensor([[out]], dtype=torch.int32, device=tree.device)


def iteration_rows(tree, idx, k_runs, n_iters=2048, reps=10,
                   slices=1) -> int:
    """Distinct table rows the chains read (rows ``row`` and ``row + 1`` of
    every start they take): where decisions fire, ``acc mod 3`` moves the
    starts, so this depends on the data (and on ``slices``: each slice's
    chain starts from 0)."""
    _, starts = _iteration_chain(tree, idx, k_runs, n_iters, reps, slices)
    rows = {(s // 16) % (tree.shape[0] - 2) for s in starts}
    return len(rows | {r + 1 for r in rows})


def iteration_step_rows(s0, n_cells):
    """The distinct rows the card-wide 6d step loads for a run whose start
    before ``acc`` is ``s0`` (its other two loads repeat the first two),
    and for ``a`` = 0, 1, 2 the pair ``p_a`` that
    start ``s0 + a`` reads, ``(rows[p_a], rows[p_a + 1])``: rows ``r0``,
    ``r0 + 1`` (``r0 = (s0 div 16) mod (n_cells - 2)``), then ``r0 + 2``
    where ``s0 + 2`` crosses a multiple of 16, or ``r2, r2 + 1`` where its
    row wraps at ``n_cells - 2`` (or ``s0 + 2`` wraps in int32)."""
    m = n_cells - 2
    f0, f1, f2 = (_i32(s0 + a) >> 4 for a in range(3))   # floor(s / 16)
    r0 = f0 % m
    r2 = r0 if f2 == f0 else (r0 + 1) % m if f2 == f0 + 1 else f2 % m
    p2 = 0 if r2 == r0 else 1 if r2 == r0 + 1 else 2
    rows = [r0, r0 + 1] + ([] if p2 == 0 else [r0 + 2] if p2 == 1
                           else [r2, r2 + 1])
    return rows, (0, 0 if f1 == f0 else p2, p2)


def iteration_core(tree, idx, k_runs, n_iters=2048, reps=10, *,
                   spread="warp", slices=None, warps=8):
    """6d: one warp, ``k_runs`` two-row reads in flight a step, shuffle
    alignment and shifts, the decision word by ``__ballot_sync``.
    ``spread="card"``: the steps cut into ``slices``, one warp each,
    ``warps`` (1-8) a block, each slice's chain from 0 with the rows of
    the next two steps loaded before the current step's decision, the
    results added by a second kernel
    (:func:`iteration_core_card_reference`); ``slices=1`` is the probe's
    chain.  It takes tables of up to 2^26 rows (32-bit row offsets)."""
    if k_runs not in K_RUNS:
        raise ValueError(f"iteration_core: k_runs {k_runs} not in {K_RUNS}")
    if idx.shape[0] < n_iters * k_runs:
        raise ValueError("iteration_core: idx shorter than n_iters * k_runs")
    if tree.shape[0] < 3:
        raise ValueError(f"iteration_core: {tree.shape[0]} rows, fewer "
                         f"than 3 (rows are taken mod n_cells - 2)")
    _check_spread("iteration_core", spread, slices, warps, ITER_WARPS)
    card = spread == "card"
    if card and tree.shape[0] > 1 << 26:
        raise ValueError(f"iteration_core: spread='card' takes at most 2^26 "
                         f"rows, got {tree.shape[0]}")
    if not _on_card("iteration_core", tree, idx):
        if card:
            return iteration_core_card_reference(tree, idx, k_runs, n_iters,
                                                 reps, slices)
        return iteration_core_reference(tree, idx, k_runs, n_iters, reps)
    _table_args("iteration_core", tree, idx)
    out = torch.empty((1, 1), dtype=torch.int32, device=tree.device)
    if card:
        partial = torch.empty(slices, dtype=torch.int32, device=tree.device)
        _kernels.check(_kernels.entry.spatialsim_probe_iteration_core_card(
            tree.data_ptr(), idx.data_ptr(), partial.data_ptr(),
            out.data_ptr(), tree.shape[0], int(k_runs), int(n_iters),
            int(reps), slices, warps, _kernels.stream(tree)),
            "probe_iteration_core_card")
        iteration_core.card_launches += 1
    else:
        _kernels.check(_kernels.entry.spatialsim_probe_iteration_core(
            tree.data_ptr(), idx.data_ptr(), out.data_ptr(), tree.shape[0],
            int(k_runs), int(n_iters), int(reps), _kernels.stream(tree)),
            "probe_iteration_core")
    iteration_core.launches += 1
    return out


iteration_core.launches = 0
iteration_core.card_launches = 0


def iteration_inputs(k_runs, *, scale=1e-6, n_iters=2048, n_cells=8192,
                     device="cuda"):
    """decide18's iteration-core inputs: ``arange * scale`` (the probe's
    1e-6, at which no decision fires) and the run starts."""
    return (table(n_cells, device, scale),
            indices(n_cells - 2, n_iters * k_runs, device))


def probe_iteration_shapes(k_runs, *, scale=1e-6, n_iters=2048, reps=10,
                           spread="warp", slices=None, warps=8,
                           device="cuda"):
    tree, idx = iteration_inputs(k_runs, scale=scale, n_iters=n_iters,
                                 device=device)
    return iteration_core(tree, idx, k_runs, n_iters, reps, spread=spread,
                          slices=slices, warps=warps)


KERNELS = (row_reads, block_read, reduce_roundtrip, row_write, roll,
           scalar_load_dynsub, scalar_load_dyn_dyn, extract8, smem_table,
           gated_reduce, row_store, iteration_core)
