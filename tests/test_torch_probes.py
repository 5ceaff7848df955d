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
  (997 is odd): at larger sizes its table holds unwritten memory.
* 5d and 6c run at 64 cells, where some index is 0, so the row they
  return is written; their whole scratch tables are held to numpy.
* 6d returns 0 at its own table scale (1e-6: no decision fires), so the
  plain version is also held to an independent numpy oracle, and to the
  JAX probe, at scales where decisions fire.
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


@pytest.mark.parametrize("pct", [0, 15, 100])
def test_gated_reduce(jax_probe, pct):
    want = jax_probe(decide18.probe_gated_reduce, pct)
    _same(tp.probe_gated_reduce(pct, **CPU), want)


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
    n_cells = tree.shape[0]
    lanes = np.arange(128)
    w_emit = np.where((lanes % 8 == 0) & (lanes // 8 < 8),
                      4.0 ** (lanes // 8), 0.0).astype(np.float32)
    f32 = np.float32
    acc, words = 0, []
    for _ in range(reps):
        for i in range(n_iters):
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
    # The plain versions launch nothing.
    before = [f.launches for f in tp.KERNELS]
    tp.bench_row_reads(16, 8, 1, **CPU)
    tp.probe_iteration_shapes(1, n_iters=8, reps=1, **CPU)
    assert [f.launches for f in tp.KERNELS] == before


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
    "block read": lambda d: tool15._block_read("b", 64, 32, 2, d),
    "scalar dynsub": lambda d: tool15._scalar(
        "s", tp.scalar_load_dynsub, tp.scalar_load_dynsub_reference, 64, 32,
        2, d),
    "row write": lambda d: tool15._row_write("w", 64, 32, 2, d),
    "row store": lambda d: tool18._row_store("st", 64, 32, 2, d),
    "iteration core": lambda d: tool18._iteration("i", 2, 256, 2, d),
    "iteration core where words fire": lambda d: tool18._iteration(
        "f", 2, 256, 2, d, tool18.FIRE_SCALE),
}


@pytest.mark.parametrize("name", list(TOOL_ENTRIES))
def test_tool_entries(name):
    """The tools' entries at small sizes on the CPU: the call equals the
    plain version, the output is zero only where the entry says so, and
    the library call (one PyTorch call) gives the same sum."""
    e = TOOL_ENTRIES[name](torch.device("cpu"))
    got, want = e["call"](), e["plain"]()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert (not any(bool(g.any()) for g in got)) == e["expect_zero"]
    if e["library"] is not None:
        assert torch.equal(e["library"](), got[0])
