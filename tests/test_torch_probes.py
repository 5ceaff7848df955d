"""The traversal-primitive probes of ``scripts/decide15.py`` and
``scripts/decide18.py`` against the port's plain versions
(``spatialsim_tpu_torch/ops/traversal_probes.py``), on the CPU.

Each JAX probe runs as the script defines it, with ``pl.pallas_call`` in
interpret mode and the script's ``timeit`` replaced by one call that keeps
the output; neither script changes.  The port's function of the same name
makes the same inputs on the CPU, where it takes its plain version.  Every
output compared here is integer-valued (sums of ``arange`` rows below
2^24, or int32 chains), so the comparison is exact.

* 6a runs at ``n_i32=256``, where the probe writes every table entry
  (997 is odd): at larger sizes its table holds unwritten memory.  Its
  card-wide plain version equals the JAX probe at one slice and a numpy
  oracle of the slices' chains at more; the card-wide kernel's split
  index, mirrored in Python ints, equals the floor modulo over the int32
  edges.
* 5d and 6c run at 64 cells, where some index is 0, so the row they
  return is written; their whole scratch tables are held to numpy (6c's
  card-wide plain version, a last-writer table and then the stores, to
  the serial one at every slice count).
* 6d returns 0 at its own table scale (1e-6: no decision fires), so the
  plain version is also held to an independent numpy oracle, and to the
  JAX probe, at scales where decisions fire.
* The card-wide instances of 5a, 5b, 5f, 5g and 5h (``spread="card"``)
  sum the same reads in another order: their plain versions are held to
  the JAX probes within a stated rounding bound (exactly for 5f and 5g at
  the small size, where every partial sum is an integer below 2^24), and
  with one slice to the serial plain versions bit for bit.  5d's
  card-wide instance writes the same rows: its plain version's table
  equals the JAX probe's exactly.  6d's card-wide plain version is a
  chain a slice, each from 0: at one slice it equals the JAX probe, at
  more a numpy oracle of the slices' chains.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from scripts import decide15, decide18
from spatialsim_tpu_torch.ops import traversal_probes as tp
from spatialsim_tpu_torch.tools import decide15 as tool15
from spatialsim_tpu_torch.tools import decide18 as tool18

CPU = dict(device="cpu")


@pytest.fixture
def jax_probe(monkeypatch):
    """Run a script's probe with Pallas in interpret mode; return the
    output of its kernel as numpy."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    kept = {}

    def timeit(fn, reps=5):
        kept["out"] = np.asarray(jax.tree_util.tree_leaves(fn())[0])
        return 1.0
    for mod in (decide15, decide18):
        monkeypatch.setattr(mod, "timeit", timeit)

    def run(probe, *args):
        kept.clear()
        probe(*args)
        return kept["out"]
    return run


def _same(got, want):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_row_reads(jax_probe, width):
    want = jax_probe(decide15.bench_row_reads, 64, 32, 2, width)
    _same(tp.bench_row_reads(64, 32, 2, width, **CPU), want)
    # Placement and chaining change how the card reads, not the function.
    _same(tp.bench_row_reads(64, 32, 2, width, chained=True,
                             where="shared", **CPU), want)


def test_block_read(jax_probe):
    want = jax_probe(decide15.bench_block_read, 64, 32, 2)
    _same(tp.bench_block_read(64, 32, 2, **CPU), want)


# Slice counts of the card-wide tests: one slice, uneven slices (7 of a
# 64-read stream: 9 and 10 reads, which no width above 1 divides), and
# slices shorter than the widest accumulator set (32: 2 reads each).
CARD_SLICES = (1, 7, 32)


def _card_close(got, want, terms, rows_per_slice, slices):
    """``got`` within ``(L + P) 2^-24 sum|terms|`` of ``want``, lane by
    lane: each slice adds at most L rows (L its longest) in float32, the
    second pass P partials, and each float32 add errs by at most 2^-24 of
    a running sum no larger than ``sum|terms|`` (``terms``: the rows added,
    in float64)."""
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    tol = ((rows_per_slice + slices) * 2.0 ** -24
           * terms.abs().sum(0).numpy())
    err = np.abs(got.double().numpy() - want.astype(np.float64))
    assert (err <= tol).all(), (err.max(), tol.min())


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_row_reads_card_plain_against_jax(jax_probe, width):
    want = jax_probe(decide15.bench_row_reads, 64, 32, 2, width)
    tree, idx = tp.row_inputs(64, 32, "cpu")
    used = 32 // width * width
    terms = tree[idx[:used].long()].double().repeat(2, 1)
    for slices in CARD_SLICES:
        longest = int(np.diff(tp.slice_bounds(2 * used, slices)).max())
        for chained in (False, True):
            got = tp.bench_row_reads(64, 32, 2, width, chained=chained,
                                     spread="card", slices=slices, warps=1,
                                     **CPU)
            _card_close(got, want, terms, longest, slices)


def test_block_read_card_plain_against_jax(jax_probe):
    want = jax_probe(decide15.bench_block_read, 64, 32, 2)
    tree, idx = tp.block_read_inputs(64, 32, "cpu")
    i = idx.long()
    terms = torch.cat([tree[i], tree[i + 1]]).double().repeat(2, 1)
    for slices in CARD_SLICES:
        # Two rows a read.
        longest = 2 * int(np.diff(tp.slice_bounds(64, slices)).max())
        for chained in (False, True):
            got = tp.bench_block_read(64, 32, 2, chained=chained,
                                      spread="card", slices=slices, warps=1,
                                      **CPU)
            _card_close(got, want, terms, longest, slices)


def test_card_plain_with_one_slice_is_the_serial_plain_version():
    """One slice walks the probe's reads in the probe's order, so at a
    size where the float32 chains round (8,192 cells, 4,096 reads, 3
    passes) it equals the one-warp plain version bit for bit; more slices
    round otherwise."""
    tree, idx = tp.row_inputs(8192, 4096, "cpu")
    for width in tp.WIDTHS:
        serial = tp.row_reads_reference(tree, idx, 3, width)
        assert torch.equal(
            tp.row_reads_card_reference(tree, idx, 3, width, 1), serial)
    assert not torch.equal(
        tp.row_reads_card_reference(tree, idx, 3, 1, 4224),
        tp.row_reads_reference(tree, idx, 3, 1))
    tree, idx = tp.block_read_inputs(8192, 4096, "cpu")
    assert torch.equal(tp.block_read_card_reference(tree, idx, 3, 1),
                       tp.block_read_reference(tree, idx, 3))


@pytest.mark.parametrize("use_roll", [True, False])
def test_extract8_card_plain_against_jax(jax_probe, use_roll):
    """Each visit adds 7 float32 sums of its own 8 values and one into its
    slice; a slice at most L visits, the second pass P partials.  Each add
    errs by at most 2^-24 of a running sum no larger than S = sum|x| over
    all visits, so the card-wide order is within (7 + L + P) 2^-24 S of
    the exact sum and the probe's serial order within (7 + T) 2^-24 S (T
    the visits): they differ by at most the sum of the two."""
    want = jax_probe(decide15.bench_extract8, 64, 32, 2, use_roll)
    tree, idx = tp.extract8_inputs(64, 32, "cpu")
    c = idx.long()
    cells = tree[(c // 16)[:, None], (c % 16 * 8)[:, None] + torch.arange(8)]
    s = 2 * float(cells.double().abs().sum())
    for slices in CARD_SLICES:
        longest = int(np.diff(tp.slice_bounds(64, slices)).max())
        tol = (7 + longest + slices + 7 + 64) * 2.0 ** -24 * s
        for chained in (False, True):
            got = tp.bench_extract8(64, 32, 2, use_roll, chained=chained,
                                    spread="card", slices=slices, warps=1,
                                    **CPU)
            assert got.shape == want.shape and got.numpy().dtype == want.dtype
            assert abs(float(got) - float(want[0, 0])) <= tol


def test_extract8_card_plain_with_one_slice_is_the_serial_plain_version():
    """At 8,192 cells, 4,096 visits and 3 passes the float32 chain rounds:
    one slice equals the serial plain version bit for bit, 4,224 slices
    round otherwise, and an empty stream sums to 0."""
    tree, idx = tp.extract8_inputs(8192, 4096, "cpu")
    serial = tp.extract8_reference(tree, idx, 3)
    assert torch.equal(tp.extract8_card_reference(tree, idx, 3, 1), serial)
    assert not torch.equal(tp.extract8_card_reference(tree, idx, 3, 4224),
                           serial)
    assert float(tp.extract8_card_reference(tree, idx[:0], 3, 7)) == 0.0


SCALAR_PROBES = ("probe_scalar_load_dynsub",
                 "probe_scalar_load_dyn_dyn_retry")


@pytest.mark.parametrize("probe", SCALAR_PROBES)
def test_scalar_load_card_plain_against_jax(jax_probe, probe):
    """At 64 cells x 32 reads x 2 every value, partial and sum is an
    integer below 2^24 (64 reads of at most 8,191), so every float32 add
    is exact and each slice count gives the JAX probe's output exactly."""
    want = jax_probe(getattr(decide15, probe), 64, 32, 2)
    for slices in CARD_SLICES:
        for chained in (False, True):
            _same(getattr(tp, probe)(64, 32, 2, chained=chained,
                                     spread="card", slices=slices, warps=1,
                                     **CPU), want)


@pytest.mark.parametrize("probe", SCALAR_PROBES)
def test_scalar_load_card_plain_within_its_bound_of_jax(jax_probe, probe):
    """At 8,192 cells x 4,096 reads x 3 the float32 chains round.  A slice
    adds at most L reads, the second pass P partials, the probe's serial
    chain T reads; each add errs by at most 2^-24 of a running sum no
    larger than S = sum|x| over all reads, so the card-wide order and the
    probe's differ by at most (L + P + T) 2^-24 S."""
    want = float(jax_probe(getattr(decide15, probe), 8192, 4096, 3)[0, 0])
    tree, idx = tp.row_inputs(8192, 4096, "cpu")
    vals = tp._scalar_vals(tree, idx, probe.endswith("retry")).double()
    s = 3 * float(vals.abs().sum())
    for slices in (*CARD_SLICES, 4224):
        longest = int(np.diff(tp.slice_bounds(3 * 4096, slices)).max())
        tol = (longest + slices + 3 * 4096) * 2.0 ** -24 * s
        got = getattr(tp, probe)(8192, 4096, 3, spread="card",
                                 slices=slices, warps=1, **CPU)
        assert abs(float(got) - want) <= tol


@pytest.mark.parametrize("dyn_lane", [False, True])
def test_scalar_load_card_plain_with_one_slice_is_the_serial_plain_version(
        dyn_lane):
    """Where the float32 chain rounds (8,192 cells, 4,096 reads, 3
    passes), one slice equals the serial plain version bit for bit, 4,224
    slices round otherwise, and an empty stream sums to 0."""
    tree, idx = tp.row_inputs(8192, 4096, "cpu")
    serial = (tp.scalar_load_dyn_dyn_reference if dyn_lane
              else tp.scalar_load_dynsub_reference)(tree, idx, 3)
    card = functools.partial(tp.scalar_load_card_reference,
                             dyn_lane=dyn_lane)
    assert torch.equal(card(tree, idx, 3, 1), serial)
    assert not torch.equal(card(tree, idx, 3, 4224), serial)
    assert float(card(tree, idx[:0], 3, 7)) == 0.0


def test_row_write_card_plain_is_the_probes_table(jax_probe):
    """At 64 cells some index is 0, so scr[0] is a written row; the whole
    table equals the JAX probe's output row and numpy's, at every slice
    count."""
    want = jax_probe(decide15.bench_row_write, 64, 32, 2)
    table = np.zeros((64, 128), np.float32)
    table[np.random.default_rng(0).integers(0, 64, 32)] = 2.0
    assert (table[0] == 2.0).all()
    for slices in CARD_SLICES:
        out, scr = tp.bench_row_write(64, 32, 2, spread="card",
                                      slices=slices, warps=1, **CPU)
        _same(out, want)
        np.testing.assert_array_equal(scr.numpy(), table)


@pytest.mark.parametrize("reps,batch", [(40, 1), (2, 4), (2, 8)])
def test_reduce_roundtrip(jax_probe, reps, batch):
    want = jax_probe(decide15.bench_reduce_roundtrip, 4096, reps, batch)
    got = tp.bench_reduce_roundtrip(4096, reps, batch, **CPU)
    _same(got, want)
    if batch == 1:
        # Each step adds 8128 = 127 * 64: past 2^30 (one ulp 128) the
        # float32 chain rounds, and the plain version rounds as the probe.
        assert float(want[0, 0]) > 2 ** 30
        assert float(got[0, 0]) != 4096 * reps * 8128.0


def test_row_write(jax_probe):
    want = jax_probe(decide15.bench_row_write, 64, 32, 2)
    assert (want == 2.0).all()
    out, scr = tp.bench_row_write(64, 32, 2, **CPU)
    _same(out, want)
    table = np.zeros((64, 128), np.float32)
    table[np.random.default_rng(0).integers(0, 64, 32)] = 2.0
    np.testing.assert_array_equal(scr.numpy(), table)


def test_roll(monkeypatch):
    """bench_roll prints one value; a proxy of the script's ``jax`` keeps
    the jitted call's whole output."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    kept = {}

    class _Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        def jit(self, f):
            g = jax.jit(f)
            return lambda *a: kept.setdefault("out", np.asarray(g(*a)))
    monkeypatch.setattr(decide15, "jax", _Jax())
    decide15.bench_roll()
    _same(tp.bench_roll(**CPU), kept["out"])
    x = tp.lane_row("cpu")
    for s in (0, 1, 4, 127, 128, -3, 300):
        assert torch.equal(tp.roll(x, s), torch.roll(x, s, 1))


@pytest.mark.parametrize("probe", ["probe_scalar_load_dynsub",
                                   "probe_scalar_load_dyn_dyn_retry"])
def test_scalar_loads(jax_probe, probe):
    want = jax_probe(getattr(decide15, probe), 64, 32, 2)
    _same(getattr(tp, probe)(64, 32, 2, **CPU), want)
    _same(getattr(tp, probe)(64, 32, 2, chained=True, **CPU), want)


@pytest.mark.parametrize("use_roll", [True, False])
def test_extract8(jax_probe, use_roll):
    want = jax_probe(decide15.bench_extract8, 64, 32, 2, use_roll)
    _same(tp.bench_extract8(64, 32, 2, use_roll, **CPU), want)


@pytest.mark.parametrize("where", ["shared", "global"])
def test_smem_capacity(jax_probe, where):
    want = jax_probe(decide18.probe_smem_capacity, 256)
    _same(tp.probe_smem_capacity(256, where=where, **CPU), want)


def test_smem_table_reads_zeros_past_the_writes():
    """At n > 256 the plain version's table is zero past the 256 writes
    (the kernel's too: shared memory is zero-filled, the global table is
    allocated zeroed), so the output is defined."""
    idx4 = torch.arange(4, dtype=torch.int32)
    n_ops, reps, n = 64, 2, 1024
    tbl = np.zeros(n, np.int64)
    tbl[np.arange(256) * 997 % n] = np.arange(256)
    acc = 0
    for _ in range(reps):
        for i in range(n_ops):
            acc += int(tbl[(i % 4 + i * 1009 + acc % 7) % n])
    assert int(tp.smem_table_reference(idx4, n, n_ops, reps)) == acc


@pytest.mark.parametrize("where", ["shared", "global"])
def test_smem_table_card_plain_with_one_slice_is_the_jax_probe(jax_probe,
                                                               where):
    want = jax_probe(decide18.probe_smem_capacity, 256)
    _same(tp.probe_smem_capacity(256, where=where, spread="card", slices=1,
                                 warps=1, **CPU), want)


def _smem_oracle(idx4, n, n_ops, reps, slices):
    """decide18's table read in Python ints from ``acc = 0`` over each
    slice's steps of the stream (step t at ``i = t mod n_ops``), the
    slices' results summed by numpy and wrapped to int32."""
    def wrap(x):
        return (x + 2 ** 31) % 2 ** 32 - 2 ** 31
    tbl = np.zeros(n, np.int64)
    for i in range(256):
        tbl[i * 997 % n] = i
    ids = [int(v) for v in idx4]
    total = n_ops * reps
    parts = np.zeros(slices, np.int64)
    for p in range(slices):
        acc = 0
        for t in range(p * total // slices, (p + 1) * total // slices):
            i = t % n_ops
            k = wrap(wrap(ids[i % 4] + 1009 * i) + acc % 7) % n
            acc = wrap(acc + int(tbl[k]))
        parts[p] = acc
    return wrap(int(parts.sum()))


@pytest.mark.parametrize("slices", [2, 7, 64])
def test_smem_table_card_plain_against_numpy_oracle(slices):
    """At more than one slice: each slice's chain from 0, the results added
    with int32 wrap; on the probe's offsets and on offsets near +-2^31,
    at n 1,000 (which does not divide 2^32) and 8,192."""
    n_ops, reps = 512, 3
    for idx4 in (tp.smem_inputs("cpu"), tp.smem_edge_inputs("cpu")):
        for n in (1000, 8192):
            want = _smem_oracle(idx4.tolist(), n, n_ops, reps, slices)
            got = tp.smem_table(idx4, n, n_ops, reps, where="global",
                                spread="card", slices=slices, warps=1)
            assert int(got) == want != 0, (idx4.tolist(), n, int(got), want)


# The card-wide 6a kernel's index (csrc/probes_decide18.cu table_step and
# table_index) in Python ints, as its 32-bit unsigned arithmetic.
_M32 = 0xFFFFFFFF


def _split(s, n):
    """``table_step``: (b, b2, lim) of the int32 s: b = s mod n through the
    reciprocal floor((2^32 - 1) / n) and an unsigned min, b2 = (b - 2^32
    mod n) mod n, lim = min(INT32_MAX - s, 7)."""
    u, inv = s & _M32, _M32 // n
    c = (_M32 - inv * n + 1) % n

    def sub_mod(x):
        return min((x - c) & _M32, (x - c + n) & _M32)
    r = (u - ((u * inv) >> 32) * n) & _M32
    bu = min(r, (r - n) & _M32)
    b = sub_mod(bu) if s < 0 else bu
    return b, sub_mod(b), min((0x7FFFFFFF - u) & _M32, 7)


def _mod7_parts(acc):
    """``table_index``'s acc mod 7 as (v, s7): x = acc, or -1 - acc where
    acc < 0; umulhi(x, 0x92492493) >> 2; v = x mod 7, or -1 - (x mod 7)
    where acc < 0, and s7 = 7 there."""
    sg = -1 if acc < 0 else 0
    x = (acc ^ sg) & _M32
    return (x - 7 * (((x * 0x92492493) >> 32) >> 2)) ^ sg, sg & 7


def _index(split, acc, n):
    """``table_index``: the select of b2 where v > lim - s7 (r > lim), the
    adds b + s7 + v and one conditional subtract as an unsigned min."""
    b, b2, lim = split
    v, s7 = _mod7_parts(acc)
    k = ((b2 if v > lim - s7 else b) + s7 + v) & _M32
    return min(k, (k - n) & _M32)


_EDGES = ([-2 ** 31 + k for k in range(9)] + list(range(-8, 9))
          + [2 ** 31 - 1 - k for k in range(9)])
# acc at every residue mod 7, at both signs and both int32 ends.
_ACCS = [r + 7 * m for r in range(7)
         for m in (-306_783_378, -2, -1, 0, 1, 306_783_377)] + [-2 ** 31,
                                                                1 - 2 ** 31]


@pytest.mark.parametrize("n", [7, 8, 255, 256, 8191, 8192, 131072,
                               2 ** 31 - 1])
def test_smem_split_index_is_the_floor_modulo(n):
    """The kernel's split index equals fmod_floor(wrap(s + acc mod 7), n)
    for s at the int32 edges, near 0 and at random, and acc at every
    residue mod 7 at both signs."""
    rand = np.random.default_rng(n).integers(-2 ** 31, 2 ** 31, 100)
    for s in _EDGES + [int(v) for v in rand]:
        split = _split(s, n)
        for acc in _ACCS:
            assert _index(split, acc, n) == tp._i32(s + acc % 7) % n, (
                s, acc, n)


def test_smem_mod7_is_the_floor_modulo():
    near7 = [7 * k + d for k in (-306783379, -2, -1, 0, 1, 306783378)
             for d in (-1, 0, 1)]
    rand = np.random.default_rng(7).integers(-2 ** 31, 2 ** 31, 3000)
    for a in (_EDGES + _ACCS + [tp._i32(v) for v in near7]
              + [int(v) for v in rand]):
        assert sum(_mod7_parts(a)) == a % 7, a


def test_smem_edge_inputs_fire_the_wrap():
    """On the offsets near +-2^31 the probe's chain (at n 8,191, which does
    not divide 2^32) passes INT32_MAX in ``s + acc mod 7`` at some steps,
    where the kernel's select takes b2 != b; at every step the split index
    is the plain version's."""
    n, n_ops, reps = 8191, 4096, 2
    tbl, ids = tp._smem_tables(tp.smem_edge_inputs("cpu"), n)
    acc, fired = 0, 0
    for t in range(n_ops * reps):
        i = t % n_ops
        s = tp._i32(ids[i % 4] + 1009 * i)
        split = _split(s, n)
        k = _index(split, acc, n)
        assert k == tp._i32(s + acc % 7) % n, (t, s, acc)
        fired += acc % 7 > split[2] and split[0] != split[1]
        acc = tp._i32(acc + tbl[k])
    assert fired >= reps
    assert int(tp.smem_table_reference(tp.smem_edge_inputs("cpu"), n, n_ops,
                                       reps)) == acc


def test_smem_table_card_refuses_before_any_launch(monkeypatch):
    """A bad spread, n below SMEM_MIN_N, and (as on a card whose opt-in
    limit is 232,448 B) a shared table whose block needs more: each raises
    before any launch."""
    idx4 = tp.smem_inputs("cpu")
    before = (tp.smem_table.launches, tp.smem_table.card_launches)
    for kw in (dict(spread="gpu"), dict(spread="warp", slices=4),
               dict(spread="card"), dict(spread="card", slices=0),
               dict(spread="card", slices=4, warps=3),
               dict(spread="card", slices=66, warps=33)):
        with pytest.raises(ValueError):
            tp.smem_table(idx4, 256, **kw)
    for n in (0, 6, 2 ** 31):
        with pytest.raises(ValueError, match="n_i32"):
            tp.smem_table(idx4, n, spread="card", slices=4, warps=1)
    monkeypatch.setattr(tp, "_on_card", lambda *a: True)
    monkeypatch.setattr(tp, "smem_optin_bytes", lambda dev: 232_448)
    for n, kw in ((58_109, dict(spread="card", slices=4, warps=1)),
                  (58_113, {})):
        with pytest.raises(ValueError, match="opt in"):
            tp.smem_table(idx4, n, where="shared", **kw)
    assert (tp.smem_table.launches, tp.smem_table.card_launches) == before


@pytest.mark.parametrize("pct", [0, 15, 100])
def test_gated_reduce(jax_probe, pct):
    want = jax_probe(decide18.probe_gated_reduce, pct)
    _same(tp.probe_gated_reduce(pct, **CPU), want)


def test_f32_to_i32_converts_as_xla():
    """The plain versions' word conversion against XLA's float32 -> int32
    convert: toward zero, saturating at both ends, NaN to 0."""
    xs = [3e9, -3e9, 2.0 ** 31, -2.0 ** 31, 2.0 ** 31 - 128, float("nan"),
          float("inf"), -float("inf"), 2.9, -2.9, 0.0]
    want = np.asarray(jnp.asarray(xs, jnp.float32).astype(jnp.int32))
    assert [tp._f32_to_i32(np.float32(x)) for x in xs] == want.tolist()
    assert want[:4].tolist() == [2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1,
                                 -2 ** 31] and want[5] == 0


class _Jnp24:
    """The script's ``jnp`` with ``arange`` scaled by 2^24 (exact): the
    gated reduce's row then sums to 8,128 x 2^24, past 2^31, so each word
    saturates."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    def arange(self, *a, **kw):
        return jnp.arange(*a, **kw) * 2 ** 24


@pytest.mark.parametrize("pct", [0, 15, 100])
def test_gated_reduce_saturates_as_the_probe(jax_probe, monkeypatch, pct):
    """Where each word passes 2^31 (arange x 2^24) the plain version
    converts it as XLA and the kernels do (saturating) and gives the JAX
    probe's int32 (it gave 0 at 15% when it wrapped the unbounded sum)."""
    monkeypatch.setattr(decide18, "jnp", _Jnp24())
    want = jax_probe(decide18.probe_gated_reduce, pct)
    _same(tp.gated_reduce(tp.lane_row("cpu") * 2 ** 24, pct), want)
    if pct == 15:
        assert int(want[0, 0]) == -94220


@pytest.mark.parametrize("pct", [0, 15, 100])
def test_gated_reduce_card_plain_with_one_slice_is_the_jax_probe(jax_probe,
                                                                 pct):
    want = jax_probe(decide18.probe_gated_reduce, pct)
    _same(tp.probe_gated_reduce(pct, spread="card", slices=1, warps=1, **CPU),
          want)
    if pct == 15:
        assert int(want[0, 0]) == 865794560


def _gated_oracle(v, pct, n_ops, t0, t1):
    """decide18's gated reduce in numpy from ``acc = 0`` over the steps
    ``t0`` to ``t1`` of the stream (step t at ``i = t mod n_ops``): each
    word the float32 sum, truncated and clipped to int32 (NaN to 0)."""
    def word(s):
        s = float(s)
        return 0 if s != s else int(np.clip(np.trunc(s), -2 ** 31,
                                            2 ** 31 - 1))
    f32, acc = np.float32, 0
    for t in range(t0, t1):
        i = t % n_ops
        tt = f32(f32(acc) * f32(1e-20))
        w = word(np.sum(v + tt, dtype=np.float32))
        add = word(np.sum(v * f32(2) + tt, dtype=np.float32))
        hit = tp._i32(w + i) % 100 < pct
        acc = tp._i32(acc + w + (add if hit else 0))
    return acc


@pytest.mark.parametrize("slices", [7, 96, 4224])
def test_gated_reduce_card_plain_against_numpy_oracle(slices):
    """At more than one slice: each slice's chain from 0 by the numpy
    oracle (a slice starts its gate at its first step's i), the results
    added with int32 wrap; on the probe's row, where each word saturates
    (arange x 2^24) and where it is negative."""
    n_ops, reps, pct = 512, 4, 15
    b = tp.slice_bounds(reps * n_ops, slices)
    for scale in (1.0, 2.0 ** 24, -3.0):
        x = tp.lane_row("cpu") * scale
        want = 0
        for p in range(slices):
            want = tp._i32(want + _gated_oracle(
                x.numpy().ravel(), pct, n_ops, int(b[p]), int(b[p + 1])))
        got = tp.gated_reduce(x, pct, n_ops, reps, spread="card",
                              slices=slices, warps=1)
        assert int(got) == want != 0, (scale, int(got), want)


@pytest.mark.parametrize("reps,batch", [(40, 1), (2, 4), (2, 8)])
def test_reduce_roundtrip_card_plain_with_one_slice_is_the_jax_probe(
        jax_probe, reps, batch):
    want = jax_probe(decide15.bench_reduce_roundtrip, 4096, reps, batch)
    _same(tp.bench_reduce_roundtrip(4096, reps, batch, spread="card",
                                    slices=1, warps=1, **CPU), want)


@pytest.mark.parametrize("slices", [7, 96, 4224])
def test_reduce_roundtrip_card_plain_against_numpy_oracle(slices):
    """At more than one slice: each slice's float32 chain from 0 by numpy,
    then the partials added serially in slice order.  The row is arange
    with element 0 set to 1: it sums to 8,129, so a step adds 8,129, 33,284
    or 68,616 at b1, b4, b8 (2^0, 2^2, 2^3 times an odd number), and past
    2^24, 2^26, 2^27 the float32 chain rounds (after ~2,000 of the 4,096
    steps): 7 and 96 slices round otherwise than one; 4,224 slices, at most
    one step each, add the steps in the serial chain's order."""
    f32 = np.float32
    x = tp.lane_row("cpu").clone()
    x[0, 0] = 1.0
    v = x.numpy().ravel()
    n_ops, reps = 2048, 2
    b = tp.slice_bounds(reps * n_ops, slices)
    for batch in tp.BATCHES:
        want = f32(0)
        for p in range(slices):
            acc = f32(0)
            for _ in range(int(b[p + 1] - b[p])):
                f = f32(f32(1) + acc * f32(1e-20))
                s = f32(0)
                for k in range(batch):
                    sb = np.sum(v * f + f32(k), dtype=np.float32)
                    s = sb if k == 0 else f32(s + sb)
                acc = f32(acc + s)
            want = f32(want + acc)
        got = tp.reduce_roundtrip(x, n_ops, reps, batch, spread="card",
                                  slices=slices, warps=1)
        assert float(got) == float(want), (batch, float(got), float(want))
        assert torch.equal(got, tp.reduce_roundtrip(x, n_ops, reps, batch)
                           ) == (slices >= n_ops * reps)


def test_row_store(jax_probe):
    want = jax_probe(decide18.probe_row_store, 64)
    out, scr = tp.probe_row_store(64, **CPU)
    _same(out, want)
    assert want[0, 5] > 5.0          # a late index 0 won: row 0 is written
    table = np.zeros((64, 128), np.float32)
    for i, c in enumerate(np.random.default_rng(0).integers(0, 64, 4096)):
        table[c] = np.arange(128) + i
    np.testing.assert_array_equal(scr.numpy(), table)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_iteration_shapes_at_the_probe_scale(jax_probe, k):
    want = jax_probe(decide18.probe_iteration_shapes, k)
    assert int(want[0, 0]) == 0      # no decision fires at 1e-6
    _same(tp.probe_iteration_shapes(k, **CPU), want)


def _oracle(tree, idx, k, n_iters, reps):
    """decide18's iteration core in numpy float32, one run at a time, with
    the probe's rolls and lane select."""
    return _oracle_steps(tree, idx, k, n_iters, 0, reps * n_iters)


def _oracle_steps(tree, idx, k, n_iters, t0, t1):
    """:func:`_oracle`'s chain from ``acc = 0`` over the steps ``t0`` to
    ``t1`` of the stream (step t at ``i = t mod n_iters``)."""
    n_cells = tree.shape[0]
    lanes = np.arange(128)
    w_emit = np.where((lanes % 8 == 0) & (lanes // 8 < 8),
                      4.0 ** (lanes // 8), 0.0).astype(np.float32)
    f32 = np.float32
    acc, words = 0, []
    for t in range(t0, t1):
        i = t % n_iters
        out = acc
        for q in range(k):
            s = int(idx[i * k + q]) + acc % 3
            row, base8 = s // 16, (s % 16) * 8
            blk = tree[row % (n_cells - 2):row % (n_cells - 2) + 2]
            amt = (128 - base8) % 128
            al = np.where(lanes < 128 - base8, np.roll(blk[0], amt),
                          np.roll(blk[1], amt))
            bsv, bev, cxv = (np.roll(al, a) for a in (126, 125, 124))
            gx = np.maximum(f32(1.0) - cxv, cxv - f32(2.0))
            dmin = gx * gx + f32(1.0)
            accept = (al < f32(0.64) * dmin) | (bev - bsv <= f32(1.0))
            em = (bev > bsv) & accept & (bsv > f32(100.0))
            word = int(np.sum(np.where(em, f32(1.0), f32(0.0)) * w_emit))
            words.append(word)
            out += word % 5
        acc = out
    return acc, words


# 6c's and 6d's card-wide slice counts: one slice, uneven slices, the
# tools' P, and more slices than stores or steps.
CARD_SLICES_6 = (1, 7, 96, 4224, 12_289)


def test_row_store_card_plain_is_the_probes_table(jax_probe):
    """The card-wide plain version (a last-writer table, then every store
    with its row's last writer's bits) gives the JAX probe's output row
    and the serial plain version's whole table at every slice count, at
    the probe's 4,096 x 20 stores and at 8 x 2 (more slices than
    stores, some rows stored twice); at reps 0 neither stores."""
    want = jax_probe(decide18.probe_row_store, 64)
    idx = tp.indices(64, 4096, "cpu")
    table = tp.row_store_reference(idx, 64, 20)[1]
    few_idx = tp.indices(4, 8, "cpu")             # duplicates: 8 into 4
    few = tp.row_store_reference(few_idx, 64, 2)
    assert bool(few[1].any()) and int((few[1] != 0).any(1).sum()) < 8
    for slices in CARD_SLICES_6:
        out, scr = tp.probe_row_store(64, spread="card", slices=slices,
                                      warps=1, **CPU)
        _same(out, want)
        assert torch.equal(scr, table)
        got = tp.row_store(few_idx, 64, 2, spread="card", slices=slices,
                           warps=1)
        assert all(torch.equal(g, w) for g, w in zip(got, few))
    for reference in (tp.row_store_reference,
                      functools.partial(tp.row_store_card_reference,
                                        slices=7)):
        assert not any(bool(t.any()) for t in reference(idx, 64, 0))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("fire", [False, True])
def test_iteration_core_card_plain_with_one_slice_is_the_jax_probe(
        jax_probe, monkeypatch, k, fire):
    """At one slice the card-wide plain version is the probe's chain: the
    JAX probe's int32 at the probe's table scale (no decision fires) and
    at 2^18 x 1e-6 (decisions fire), for each k."""
    scale = 1e-6
    if fire:
        class _Jnp:
            def __getattr__(self, name):
                return getattr(jnp, name)

            def arange(self, *a, **kw):
                return jnp.arange(*a, **kw) * 2 ** 18
        monkeypatch.setattr(decide18, "jnp", _Jnp())
        scale = tool18.FIRE_SCALE
    want = jax_probe(decide18.probe_iteration_shapes, k)
    assert (int(want[0, 0]) != 0) == fire
    _same(tp.probe_iteration_shapes(k, scale=scale, spread="card", slices=1,
                                    warps=1, **CPU), want)


def _wrap_inputs(k, n_iters):
    """A 6-row table (scale 1) and starts in [-64, 192): rows wrap at
    n_cells - 2, so steps load 3 and 4 rows, and decisions fire."""
    return tp.table(6, "cpu"), torch.as_tensor(
        np.random.default_rng(1).integers(-64, 192, n_iters * k).astype(
            np.int32))


@pytest.mark.parametrize("slices", [7, 96, 4224])
@pytest.mark.parametrize("table", ["fire", "wrap"])
def test_iteration_core_card_plain_against_numpy_oracle(slices, table):
    """At more than one slice: each slice's chain from 0 by the numpy
    oracle, the results added with int32 wrap."""
    k, n_iters, reps = 2, 256, 2
    tree, idx = (_wrap_inputs(k, n_iters) if table == "wrap" else
                 tp.iteration_inputs(k, scale=tool18.FIRE_SCALE,
                                     n_iters=n_iters, device="cpu"))
    b = tp.slice_bounds(reps * n_iters, slices)
    want, words = 0, []
    for p in range(slices):
        acc, w = _oracle_steps(tree.numpy(), idx.numpy(), k, n_iters,
                               int(b[p]), int(b[p + 1]))
        want, words = tp._i32(want + acc), words + w
    assert any(words) and want != 0
    got = tp.iteration_core_card_reference(tree, idx, k, n_iters, reps,
                                           slices)
    assert int(got) == want


def test_iteration_step_rows_cover_every_start():
    """The rows the card-wide 6d step loads for a start s0 (before acc is
    known) hold the two rows that start s0 + a3 reads, for every s0 from
    -48 to past two wraps of a 6-row table's rows and at the int32 edge,
    and every a3; the 3-row and 4-row (wrap) cases occur."""
    n_cells, m = 6, 4
    sizes = set()
    for s0 in [*range(-48, 16 * m * 2 + 16), 2 ** 31 - 3, 2 ** 31 - 2,
               2 ** 31 - 1, -2 ** 31]:
        rows, pairs = tp.iteration_step_rows(s0, n_cells)
        sizes.add(len(rows))
        assert all(0 <= r < n_cells for r in rows)
        assert len(set(rows)) == len(rows)
        for a3 in range(3):
            r = (tp._i32(s0 + a3) // 16) % m
            assert rows[pairs[a3]:pairs[a3] + 2] == [r, r + 1], (s0, a3)
    assert sizes == {2, 3, 4}


@pytest.mark.parametrize("scale", [1e-6 * 2 ** 18, 1e-6 * 2 ** 19])
def test_iteration_core_against_numpy_oracle(scale):
    k, n_iters, reps = 2, 1024, 2
    tree, idx = tp.iteration_inputs(k, scale=scale, n_iters=n_iters,
                                    device="cpu")
    want, words = _oracle(tree.numpy(), idx.numpy(), k, n_iters, reps)
    # Decisions fire: full words (21845) and partial ones, and the chain's
    # result is not 0.  (On an arange table the word is the bsv > 100
    # threshold: where it holds, the opening test holds too.)
    assert max(words) == 21845 and any(0 < w < 21845 for w in words)
    assert want != 0
    got = tp.iteration_core_reference(tree, idx, k, n_iters, reps)
    assert int(got) == want


def test_iteration_core_against_jax_where_decisions_fire(jax_probe,
                                                         monkeypatch):
    """The probe's table at scale 2^18 * 1e-6: the script's ``jnp.arange``
    is scaled by 2^18 (exact), so its ``* 1e-6`` gives the port's
    ``arange * (2^18 * 1e-6)`` bit for bit."""
    class _Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def arange(self, *a, **kw):
            return jnp.arange(*a, **kw) * 2 ** 18
    monkeypatch.setattr(decide18, "jnp", _Jnp())
    want = jax_probe(decide18.probe_iteration_shapes, 2)
    assert int(want[0, 0]) != 0
    _same(tp.probe_iteration_shapes(2, scale=1e-6 * 2 ** 18, **CPU), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = tp.lane_row("cpu")
    with pytest.raises(ValueError):
        tp.row_reads(tp.table(8, "cpu"), tp.indices(8, 8, "cpu"), 1, width=3)
    with pytest.raises(ValueError):
        tp.row_reads(tp.table(8, "cpu"), tp.indices(8, 8, "cpu"), 1,
                     where="vmem")
    with pytest.raises(ValueError):
        tp.reduce_roundtrip(x, 4, 1, batch=2)
    with pytest.raises(ValueError):
        tp.smem_table(torch.arange(4, dtype=torch.int32), 256, where="smem")
    with pytest.raises(ValueError):
        tp.iteration_core(tp.table(8, "cpu"), tp.indices(6, 4, "cpu"), 2,
                          n_iters=4)
    with pytest.raises(ValueError):
        tp.iteration_core(tp.table(8, "cpu"), tp.indices(6, 12, "cpu"), 3,
                          n_iters=4)
    with pytest.raises(ValueError):
        tp.iteration_core(tp.table(2, "cpu"), tp.indices(1, 4, "cpu"), 1,
                          n_iters=4)
    with pytest.raises(ValueError):
        tp.row_store(tp.indices(8, 8, "cpu"), 0, 1)
    # The spread: its name, a slice count only for the card-wide instance
    # (and there a positive int), 1-32 warps a block dividing it (6d's
    # 1-8).
    tree, idx = tp.table(8, "cpu"), tp.indices(8, 8, "cpu")
    with pytest.raises(ValueError):
        tp.iteration_core(tree, idx, 1, 8, spread="card", slices=32,
                          warps=tp.ITER_WARPS * 2)
    for fn, args in ((tp.row_reads, (tree, idx, 1)),
                     (tp.block_read, (tree, tp.indices(6, 8, "cpu"), 1)),
                     (tp.reduce_roundtrip, (x, 4, 1)),
                     (tp.gated_reduce, (x, 15, 4, 1)),
                     (tp.row_write, (tree, idx, 1)),
                     (tp.extract8, (tree, tp.indices(128, 8, "cpu"), 1)),
                     (tp.scalar_load_dynsub, (tree, idx, 1)),
                     (tp.scalar_load_dyn_dyn, (tree, idx, 1)),
                     (tp.row_store, (idx, 8, 1)),
                     (tp.iteration_core, (tree, tp.indices(6, 8, "cpu"), 1,
                                          8))):
        for kw in (dict(spread="gpu"), dict(spread="grid", slices=4),
                   dict(spread="warp", slices=4), dict(spread="card"),
                   dict(spread="card", slices=0),
                   dict(spread="card", slices=-3),
                   dict(spread="card", slices=2.0),
                   dict(spread="card", slices=True),
                   dict(spread="card", slices=2 ** 31),
                   dict(spread="card", slices=4, warps=0),
                   dict(spread="card", slices=66, warps=33),
                   dict(spread="card", slices=4, warps=3),
                   dict(spread="card", slices=4, warps=None)):
            with pytest.raises(ValueError):
                fn(*args, **kw)
    # The plain versions launch nothing.
    before = [f.launches for f in tp.KERNELS]
    spread = (tp.row_reads, tp.block_read, tp.reduce_roundtrip, tp.row_write,
              tp.extract8, tp.scalar_load_dynsub, tp.scalar_load_dyn_dyn,
              tp.gated_reduce, tp.row_store, tp.iteration_core)
    cards = [f.card_launches for f in spread]
    tp.bench_row_reads(16, 8, 1, **CPU)
    tp.bench_row_reads(16, 8, 1, spread="card", slices=3, warps=1, **CPU)
    tp.bench_block_read(16, 8, 1, spread="card", slices=4, warps=2, **CPU)
    tp.bench_row_write(16, 8, 1, spread="card", slices=4, warps=4, **CPU)
    tp.bench_reduce_roundtrip(8, 2, 4, spread="card", slices=6, warps=3,
                              **CPU)
    tp.probe_gated_reduce(15, n_ops=8, reps=2, spread="card", slices=6,
                          warps=2, **CPU)
    for use_roll in (True, False):
        tp.bench_extract8(16, 8, 1, use_roll, chained=True, spread="card",
                          slices=6, warps=3, **CPU)
    for probe in SCALAR_PROBES:
        getattr(tp, probe)(16, 8, 1, chained=True, spread="card", slices=6,
                           warps=3, **CPU)
    tp.scalar_load_dynsub(tree, idx, 1, spread="card", slices=4, warps=4)
    tp.probe_iteration_shapes(1, n_iters=8, reps=1, **CPU)
    tp.probe_iteration_shapes(2, n_iters=8, reps=1, spread="card", slices=8,
                              warps=8, **CPU)
    tp.probe_row_store(16, n_ops=8, spread="card", slices=6, warps=3, **CPU)
    assert [f.launches for f in tp.KERNELS] == before
    assert [f.card_launches for f in spread] == cards


def _exact_sums(probe, reps):
    """The probes' sums in float64 (exact), from the same inputs."""
    tree = np.arange(8192 * 128, dtype=np.float64).reshape(8192, 128)
    high = {"bench_block_read": 8190, "bench_extract8": 8192 * 16}
    c = np.random.default_rng(0).integers(0, high.get(probe, 8192), 4096)
    if probe == "bench_row_reads":
        s = tree[c].sum(0)
    elif probe == "bench_block_read":
        s = (tree[c] + tree[c + 1]).sum(0)
    elif probe == "probe_scalar_load_dyn_dyn_retry":
        s = tree[c, c * 7 % 128].sum()
    else:
        s = tree[c // 16][np.arange(4096)[:, None],
                          (c % 16 * 8)[:, None] + np.arange(8)].sum()
    return s * reps


@pytest.mark.parametrize("probe", ["bench_row_reads", "bench_block_read",
                                   "probe_scalar_load_dyn_dyn_retry",
                                   "bench_extract8"])
def test_long_sums_round_as_the_probe(jax_probe, probe):
    """At 8,192 cells x 4,096 reads x 3 passes the float32 chains round
    (each lane's terms share their low bits, so all one way): the plain
    version rounds as the probe does, not as the exact sum."""
    want = jax_probe(getattr(decide15, probe), 8192, 4096, 3)
    _same(getattr(tp, probe)(8192, 4096, 3, **CPU), want)
    exact = np.asarray(_exact_sums(probe, 3), np.float32).reshape(-1)
    assert not np.array_equal(want.reshape(-1), exact)


def test_iteration_rows_follow_the_chain():
    """At the probe's scale acc stays 0 and the runs read rows idx // 16
    and idx // 16 + 1; where decisions fire, acc mod 3 moves the starts
    and more rows are read."""
    tree, idx = tp.iteration_inputs(2, n_iters=256, device="cpu")
    row = idx.numpy() // 16
    assert tp.iteration_rows(tree, idx, 2, 256, 2) == len(
        set(row) | set(row + 1))
    fire = tp.iteration_inputs(2, scale=tool18.FIRE_SCALE, n_iters=256,
                               device="cpu")[0]
    assert tp.iteration_rows(fire, idx, 2, 256, 2) > len(
        set(row) | set(row + 1))


# The tools' entries at small sizes, built on the CPU when a case runs.
TOOL_ENTRIES = {
    "row reads": lambda d: tool15._row_reads("r", 64, 32, 2, 2, d),
    "row reads card": lambda d: tool15._row_reads("r", 64, 32, 2, 2, d,
                                                  chained=True, card=True),
    "row reads card shared": lambda d: tool15._row_reads(
        "r", 64, 32, 2, 1, d, where="shared", card=True),
    "block read": lambda d: tool15._block_read("b", 64, 32, 2, d),
    "block read card": lambda d: tool15._block_read("b", 64, 32, 2, d,
                                                    card=True),
    "scalar dynsub": lambda d: tool15._scalar(
        "s", tp.scalar_load_dynsub, tp.scalar_load_dynsub_reference, 64, 32,
        2, d),
    "scalar dyn dyn": lambda d: tool15._scalar(
        "s", tp.scalar_load_dyn_dyn, tp.scalar_load_dyn_dyn_reference, 64,
        32, 2, d),
    "scalar dynsub card": lambda d: tool15._scalar(
        "s", tp.scalar_load_dynsub, tp.scalar_load_dynsub_reference, 64, 32,
        2, d, card=True),
    "scalar dyn dyn card chained": lambda d: tool15._scalar(
        "s", tp.scalar_load_dyn_dyn, tp.scalar_load_dyn_dyn_reference, 64,
        32, 2, d, chained=True, card=True),
    "row write": lambda d: tool15._row_write("w", 64, 32, 2, d),
    "row write card": lambda d: tool15._row_write("w", 64, 32, 2, d,
                                                  card=True),
    "extract8 card roll": lambda d: tool15._extract8("x", 64, 32, 2, True,
                                                     d, card=True),
    "extract8 card onehot chained": lambda d: tool15._extract8(
        "x", 64, 32, 2, False, d, chained=True, card=True),
    "row store": lambda d: tool18._row_store("st", 64, 32, 2, d),
    "row store card": lambda d: tool18._row_store("st", 64, 32, 2, d,
                                                  card=True),
    "iteration core": lambda d: tool18._iteration("i", 2, 256, 2, d),
    "iteration core where words fire": lambda d: tool18._iteration(
        "f", 2, 256, 2, d, tool18.FIRE_SCALE),
    "iteration core card where words fire": lambda d: tool18._iteration(
        "f", 4, 256, 2, d, tool18.FIRE_SCALE, tool15.CARD_SLICES),
    "reduce roundtrip": lambda d: tool15._reduce_roundtrip("rt", 256, 2, 4,
                                                           d),
    "reduce roundtrip card": lambda d: tool15._reduce_roundtrip(
        "rt", 4096, 2, 8, d, tool15.CARD_SLICES),
    "smem": lambda d: tool18._smem("t", 256, "shared", 64, 2, d),
    "smem card": lambda d: tool18._smem("t", 1000, "global", 512, 2, d,
                                        tool15.CARD_SLICES),
    "gated": lambda d: tool18._gated("g", 15, 512, 2, d),
    "gated card": lambda d: tool18._gated("g", 15, 4096, 2, d,
                                          tool15.CARD_SLICES),
}


@pytest.mark.parametrize("name", list(TOOL_ENTRIES))
def test_tool_entries(name):
    """The tools' entries at small sizes on the CPU: the call equals the
    plain version, the output is zero only where the entry says so, and
    the library call (one PyTorch call) gives the same sum (the row
    store's, the same table)."""
    e = TOOL_ENTRIES[name](torch.device("cpu"))
    if e["grid"]:      # the card-wide instance's call over no reads runs
        name_idle, idle = e["idle"]
        assert name_idle.endswith(f"P={tool15.CARD_SLICES}/"
                                  f"{e['grid'][1] // 32}")
        idle()
    got, want = e["call"](), e["plain"]()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert (not any(bool(g.any()) for g in got)) == e["expect_zero"]
    if e["library"] is not None:
        assert torch.equal(e["library"](), got[-1])


def test_tool_sweep_holds_each_output_to_its_plain_version(monkeypatch):
    """The tool's sweep on the CPU at two slice counts and two block
    shapes: every output equal to the plain version of its slice count,
    a record a (table, form, slices, warps); no launch floor off the
    card."""
    monkeypatch.setattr(tool15, "SWEEP_SLICES", (4, 8))
    monkeypatch.setattr(tool15, "SWEEP_WARPS", (1, 4))
    monkeypatch.setattr(tool15, "CARD_REPS", 1)
    lines = []
    res = tool15.sweep("cpu", quick=True, out=lines.append)
    assert len(res) == 2 * 2 * 2 and all(r["equal"] for r in res)
    assert len(lines) == 4 and "MISMATCH" not in "".join(lines)
    assert tool15.launch_floor_ms((528, 256), "cpu") is None


def test_tool_scalar_sweep_holds_each_output_to_its_plain_version(
        monkeypatch):
    """The tool's 5f sweep on the CPU at two slice counts and two block
    shapes, plain and chained, on the 8K table and a 64-row one in the
    octree table's place: every output equal to the plain version of its
    slice count."""
    monkeypatch.setattr(tool15, "SWEEP_SLICES", (4, 8))
    monkeypatch.setattr(tool15, "SCALAR_SWEEP_WARPS", (1, 4))
    monkeypatch.setattr(tool15, "PAST_L2_OPS", 32)
    monkeypatch.setattr(tool15, "CARD_REPS", 1)
    lines = []
    res = tool15.scalar_sweep("cpu", 64, quick=True, out=lines.append)
    assert len(res) == 2 * 2 * 2 * 2 and all(r["equal"] for r in res)
    assert {r["table"] for r in res} == {"8K 4096x20", "64 cells 32x1"}
    assert len(lines) == 8 and "MISMATCH" not in "".join(lines)
