"""The matrix-form window eval's kernel design (``csrc/window_eval_mxu.cu``)
on the CPU: what its two instances may change and what they may not.

* The folded cross term: ``dot3_fma(-2 t, s)`` is ``-2 dot3_fma(t, s)`` bit
  for bit, so d^2 built from it is the function's d^2 bit for bit (the
  register tile holds -2 t_c).
* A model of the tensor-core instance's split-TF32 contraction: w and s_c
  split into a TF32 high part (``cvt.rna``) and a remainder that the
  tensor core reads truncated, B packed per source as ``[s_hi, 1, s_lo,
  0]``, the ``mma.m16n8k8`` fragment maps as the kernel names them, its
  batches and its epilogue's shuffles.  It reproduces sum w and sum w s_c,
  and its eval holds the JAX package's bars against ``pallas_window_eval(
  ..., use_mxu=True)`` (Pallas in interpret mode).
* The design decision: the same model with a 3xTF32 cross term breaks the
  function on clusters ~1,000 from the origin, so d^2 stays on CUDA cores.
* ``mxu_plan``, the launcher's argument checks, and the tool's labels and
  HMMA counts of the instances.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu.ops.bh_eval_kernel import pallas_window_eval
from spatialsim_tpu_torch import _kernels
from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
from spatialsim_tpu_torch.tools import eval_tiles
from test_torch_eval_forms import EKW, cluster_case, jax_case

# mma.m16n8k8 .tf32 fragment maps as csrc/window_eval_mxu.cu names them
# (lane = 4 g + q, v a register): a[v] at (g + A_ROW_STEP (v & 1), q +
# A_COL_STEP (v >> 1)); b[v] at (q + B_ROW_STEP v, g); c[v] at (g +
# C_ROW_STEP (v >> 1), 2 q + (v & 1)).  B's columns: hi(s) at 0-2, 1 at
# B_ONE, lo(s) from B_LO; lane q + LO_LANE holds the lo columns of lane q's.
MMA_CONSTANTS = dict(kARowStep=8, kAColStep=4, kBRowStep=4, kCRowStep=8,
                     kBOne=3, kBLo=4, kLoLane=2)
LANES = torch.arange(32)
G_OF, Q_OF = LANES // 4, LANES % 4


def _a_map():
    v = torch.arange(4)
    k = MMA_CONSTANTS
    return (G_OF[:, None] + k["kARowStep"] * (v & 1),
            Q_OF[:, None] + k["kAColStep"] * (v >> 1))


def _b_map():
    v = torch.arange(2)
    return (Q_OF[:, None] + MMA_CONSTANTS["kBRowStep"] * v,
            G_OF[:, None].expand(32, 2))


def _c_map():
    v = torch.arange(4)
    return (G_OF[:, None] + MMA_CONSTANTS["kCRowStep"] * (v >> 1),
            2 * Q_OF[:, None] + (v & 1))


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: float32 to the nearest TF32, ties away from
    zero (the low 13 bits cleared)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """A float32 as the tensor core reads it for a TF32 operand: the low 13
    bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    """(hi, lo): hi = cvt.rna(x), lo = x - hi (exact in float32) as read."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mma(d, a, b):
    """``d + a @ b`` of one ``mma.m16n8k8``: TF32 products, exact in
    float64, summed there and rounded to the float32 accumulator."""
    return (d.double() + a.double() @ b.double()).float()


def _round_trip(mat, rows, cols):
    """A matrix through its fragments and back: lane l's register v holds
    mat[rows[l, v], cols[l, v]]; a map that misses or repeats a position
    loses it."""
    frag = mat[..., rows, cols]
    out = torch.zeros_like(mat)
    out[..., rows, cols] = frag
    return out


def _cross_3xtf32(tc, sc):
    """t_c . s_c by three TF32 mma passes (lo.hi, hi.lo, hi.hi), each
    accumulated into float32: ``(C, gsz, S)``."""
    th, tl = zip(*(split_tf32(x) for x in tc))
    sh, sl = zip(*(split_tf32(x) for x in sc))

    def dot(u, v):
        return sum(a[:, :, None].double() * b[:, None, :].double()
                   for a, b in zip(u, v))
    d = dot(tl, sh).float()
    d = (d.double() + dot(th, sl)).float()
    return (d.double() + dot(th, sh)).float()


def _epilogue(acc):
    """The kernel's epilogue on the accumulator tiles ``(..., 16, 8)``:
    each lane's C registers, columns B_LO.. added onto 0.. from lane q +
    LO_LANE, then lanes q = 0 and 1 swap halves; q = 0 gives row g and q = 1
    row g + 8 as (sum w x, sum w y, sum w z, sum w).  Returns ``(..., 16,
    4)``."""
    cr, cc = _c_map()
    c = acc[..., cr, cc]                                  # (..., 32, 4)
    s = c + c[..., LANES ^ MMA_CONSTANTS["kLoLane"], :]
    q0 = (Q_OF == 0)[:, None]
    send = torch.where(q0, s[..., 2:4], s[..., 0:2])
    r = send[..., LANES ^ 1, :]
    out = torch.zeros(acc.shape[:-2] + (16, 4), dtype=acc.dtype)
    lanes0, lanes1 = LANES[Q_OF == 0], LANES[Q_OF == 1]
    out[..., G_OF[lanes0], :] = torch.cat([s[..., lanes0, 0:2],
                                           r[..., lanes0, :]], -1)
    out[..., G_OF[lanes1] + 8, :] = torch.cat([r[..., lanes1, :],
                                               s[..., lanes1, 2:4]], -1)
    return out


def _contract(w, sc, nthr, pieces):
    """The tensor-core instance's sums of one chunk of groups: w ``(C, gsz,
    S)``, sources ``sc`` three ``(C, S)``; the source axis in batches
    (``pieces``: their lengths), each padded to 8 and summed by k8 steps of
    two mma (w_hi, then w_lo, on B = [s_hi, 1, s_lo, 0]) into the batch's
    accumulator, which then adds into the running one.  Returns the
    epilogue's ``(C, gsz, 4)`` and the accumulator tiles."""
    C, gsz, _ = w.shape
    nt = gsz // 16
    hi, lo = zip(*(split_tf32(x) for x in sc))
    k = MMA_CONSTANTS
    bmat = torch.zeros(sc[0].shape + (8,))
    for r in range(3):
        bmat[..., r], bmat[..., k["kBLo"] + r] = hi[r], lo[r]
    bmat[..., k["kBOne"]] = 1.0
    whi, wlo = split_tf32(w)
    ar, ac = _a_map()
    br, bc = _b_map()
    run = torch.zeros(C, nt, 16, 8)
    s0 = 0
    for n in pieces:
        part = torch.zeros(C, nt, 16, 8)
        for k0 in range(s0, s0 + n, 8):
            k1 = min(k0 + 8, s0 + n)
            step = torch.zeros(C, 8, 8)
            step[:, :k1 - k0] = bmat[:, k0:k1]
            b = _round_trip(step, br, bc)[:, None]
            for wpart in (whi, wlo):
                a = torch.zeros(C, gsz, 8)
                a[:, :, :k1 - k0] = wpart[:, :, k0:k1]
                a = _round_trip(a.reshape(C, nt, 16, 8), ar, ac)
                part = mma(part, a, b)
        run = run + part
        s0 += n
    return _epilogue(run).reshape(C, gsz, 4), run


def _pieces(n_groups, gsz, n_far, nthr):
    """Batch lengths along a chunk's source axis: each window or near block
    in ceil(gsz / nthr) batches, then the far slots in batches of nthr."""
    per = [min(nthr, gsz - o) for o in range(0, gsz, nthr)]
    return per * n_groups + [min(nthr, n_far - o)
                             for o in range(0, n_far, nthr)]


def mma_model(s_pos, s_mass, far, far_n, near=None, steps_since=0, dt=0.0,
              *, G, softening, group_size=256, window_groups=2,
              tau_clamp=24.0, far_tile=512, M=2, cross="fma", sums=None):
    """The matrix form as the tensor-core instance computes it: d^2 and w
    as ``window_eval_mxu_reference`` rounds them (``cross="fma"``; with
    ``"3xtf32"`` the cross term by :func:`_cross_3xtf32` instead), the
    contraction by :func:`_contract` in batches of ``32 ceil(gsz / 16 M)``
    sources.  ``sums`` (a list) collects per chunk (w, sc, the epilogue's
    sums)."""
    tau, coef2 = ek.advance_coefs(steps_since, dt, tau_clamp)
    gsz, wg = group_size, window_groups
    L = far.shape[2]
    K = 0 if near is None else near.shape[1]
    soft_sq = float(softening) ** 2
    n_use = ek._tile_counts(far_n, L, far_tile)
    Lm = max(1, int(n_use.max()))
    nthr = 32 * -(-gsz // (16 * M))
    out = []
    for _, g, t, src in ek._dense_chunks(s_pos, s_mass, near, Lm, gsz, wg,
                                         None):
        fp, fm, _ = ek._far_sources(far, g, n_use, Lm, tau, coef2)
        center = (t.double().sum(dim=2, keepdim=True) / gsz).to(t.dtype)
        tc = t - center
        sc = [torch.cat([src[r], fp[r]], dim=1) - center[r] for r in range(3)]
        sm = torch.cat([src[3], fm], dim=1)
        ti_sq = ek._dot3_fma(tc, tc)
        ps_sq = ek._dot3_fma(sc, sc)
        if cross == "fma":
            cr = ek._dot3_fma([x[:, :, None] for x in tc],
                              [x[:, None, :] for x in sc])
        else:
            cr = _cross_3xtf32(tc, sc)
        d2 = ((ti_sq[:, :, None] + ps_sq[:, None, :]) - 2.0 * cr) + soft_sq
        inv = torch.rsqrt(torch.clamp(d2, min=soft_sq))
        w = sm[:, None, :] * (inv * inv * inv)
        res, _ = _contract(w, sc, nthr,
                           _pieces(2 * wg + 1 + K, gsz, Lm, nthr))
        if sums is not None:
            sums.append((w, sc, res))
        out.append(torch.stack(
            [(res[..., r] - tc[r] * res[..., 3]) * G for r in range(3)])
            .reshape(3, -1))
    return torch.cat(out, dim=1)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# (a) the folded cross term
# ---------------------------------------------------------------------------

def _vectors(case, n=4096):
    rng = np.random.default_rng({"random": 0, "grid": 1, "edges": 2}[case])
    if case == "random":
        mag = 10.0 ** rng.uniform(-3, 4, size=(2, 3, n))
        v = mag * rng.choice([-1.0, 1.0], size=(2, 3, n))
    elif case == "grid":
        v = rng.integers(-64_000, 64_000, size=(2, 3, n)) / 64.0
    else:
        base = 10.0 ** rng.uniform(-3, 4, size=(3, n))
        base *= rng.choice([-1.0, 1.0], size=(3, n))
        other = np.stack([base, -base, base * 0.5, np.zeros_like(base)])
        other = other[rng.integers(0, 4, n), :, np.arange(n)].T
        v = np.stack([base, other])
        v[1, :, ::5] = v[0, :, ::5]                      # t = s exactly
    v = v.astype(np.float32)
    return torch.from_numpy(v[0]), torch.from_numpy(v[1])


@pytest.mark.parametrize("case", ["random", "grid", "edges"])
def test_folded_cross_term_is_bit_equal(case):
    """``dot3_fma(-2 t, s) == -2 dot3_fma(t, s)``, bit for bit but for the
    sign of an exact zero (a sum that cancels to 0 is +0 either way), and
    d^2 = ((|t|^2 + |s|^2) + dot3_fma(-2 t, s)) + eps^2 equals the
    function's ((|t|^2 + |s|^2) - 2 dot3_fma(t, s)) + eps^2 bit for bit."""
    t, s = _vectors(case)
    cross = ek._dot3_fma(t, s)
    folded = ek._dot3_fma(-2.0 * t, s)
    assert torch.equal(folded, -2.0 * cross)
    nz = cross != 0
    assert torch.equal(folded[nz].view(torch.int32),
                       (-2.0 * cross[nz]).view(torch.int32))
    ti, sp = ek._dot3_fma(t, t), ek._dot3_fma(s, s)
    for soft_sq in (4.0, 0.01, 0.0):
        want = ((ti + sp) - 2.0 * cross) + soft_sq
        got = ((ti + sp) + folded) + soft_sq
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # The chain is not exact: the fold is not trivially so.
    exact = (t.double() * s.double()).sum(0)
    assert bool((cross.double() != exact).any())


# ---------------------------------------------------------------------------
# (b) the split-TF32 contraction
# ---------------------------------------------------------------------------

def test_fragment_maps_cover_each_tile_once():
    """A and C each cover the 16 x 8 tile once over the 32 lanes' 4
    registers, B the 8 x 8 tile once over 2; B's rows are A's columns."""
    for (rows, cols), shape in ((_a_map(), (16, 8)), (_b_map(), (8, 8)),
                                (_c_map(), (16, 8))):
        hits = torch.zeros(shape, dtype=torch.int64)
        hits.index_put_((rows, cols), torch.ones_like(rows), accumulate=True)
        assert bool((hits == 1).all())
    assert bool((_a_map()[1][:, 2:] == _b_map()[0][:, 1:2]).all())


def test_kernel_names_the_model_constants():
    """The model's fragment and column constants are the kernel's."""
    src = (_kernels.CSRC_DIR / "window_eval_mxu.cu").read_text()
    found = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    for name, value in MMA_CONSTANTS.items():
        assert int(found[name]) == value, name
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "(__float_as_uint(x) + 0x1000u) & ~0x1FFFu" in src   # tf32_rna


def test_tf32_split():
    """cvt.rna rounds to 10 fraction bits, ties away from zero; hi + lo
    keeps x to ~2^-21 of |x|."""
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0])
    assert tf32_rna(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10,
                                    -(1.0 + 2.0 ** -10), 1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(10_000)
                         .astype(np.float32)) * 1e3
    hi, lo = split_tf32(y)
    assert bool(((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all())


@pytest.mark.parametrize("M", [2, 4])
def test_model_reproduces_the_sums(M):
    """sum w and sum w s_c of the model against float64 sums of the same
    w and s_c: within 2^-19 of sum |w| (|s_c|) for every target."""
    _, tl, s_pos, s_mass = jax_case(0)
    sums = []
    mma_model(torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.far,
              tl.far_n, None, 5, 0.02, M=M, sums=sums, **EKW)
    for w, sc, res in sums:
        w64 = w.double()
        for r, want in enumerate([(w64 * s.double()[:, None, :]).sum(2)
                                  for s in sc] + [w64.sum(2)]):
            scale = ((w64 * sc[r].double().abs()[:, None, :]).sum(2)
                     if r < 3 else w64.abs().sum(2))
            assert bool(((res[..., r].double() - want).abs()
                         <= scale * 2.0 ** -19).all()), r


@pytest.mark.parametrize("K", [0, 4])
def test_model_holds_the_jax_bar_on_the_galaxy(K):
    """The split-TF32 contraction on JAX's 2K galaxy lists: within 1e-4 of
    max|a| of JAX's matrix form (its Pallas-vs-XLA bar), and within 1e-4
    of the port's plain version (the card tests' bar for the kernel)."""
    jl, tl, s_pos, s_mass = jax_case(K)
    want = np.asarray(pallas_window_eval(
        jnp.asarray(s_pos), jnp.asarray(s_mass), jl.far, jl.far_n,
        jl.near if K else None, 5, 0.02, use_mxu=True, **EKW))
    args = (torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.far,
            tl.far_n, tl.near, 5, 0.02)
    got = mma_model(*args, **EKW).numpy()
    plain = ek.window_eval_mxu_reference(*args, **EKW).numpy()
    print(f"galaxy K={K}: the model {_rel(got, want):.2e} of max|a| from "
          f"JAX, {_rel(got, plain):.2e} from the plain version")
    assert _rel(got, want) <= 1e-4
    assert _rel(got, plain) <= 1e-4


def _cluster_eval(K, **model):
    s_pos, s_mass, far, far_n, near = cluster_case(K)
    kw = dict(G=0.1, softening=2.0, group_size=64, window_groups=1,
              far_tile=16)
    jax_mxu = np.asarray(pallas_window_eval(
        *(None if a is None else jnp.asarray(a)
          for a in (s_pos, s_mass, far, far_n, near)), 0, 0.02,
        use_mxu=True, **kw))
    got = mma_model(*(None if a is None else torch.from_numpy(a)
                      for a in (s_pos, s_mass, far, far_n, near)), 0, 0.02,
                    **model, **kw).numpy()
    return got, jax_mxu


@pytest.mark.parametrize("K", [0, 2])
def test_model_holds_the_jax_bar_on_clusters(K):
    """On clusters ~1,000 from the origin (exact centres), where the
    matrix form is 2-3e-2 of max|a| from the row form, the split-TF32
    contraction stays within JAX's 2e-3 bar."""
    got, jax_mxu = _cluster_eval(K)
    print(f"clusters K={K}: the model {_rel(got, jax_mxu):.2e} of max|a| "
          f"from JAX")
    assert _rel(got, jax_mxu) <= 2e-3


# ---------------------------------------------------------------------------
# (c) the design decision: d^2 stays on CUDA cores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [0, 2])
def test_3xtf32_cross_term_breaks_the_function(K):
    """The same model with the cross term t_c.s_c in 3xTF32 (three TF32 mma
    passes) is no longer the function: on the clusters it lands beyond
    JAX's 2e-3 bar, so no part of d^2 may move to the tensor cores."""
    got, jax_mxu = _cluster_eval(K, cross="3xtf32")
    print(f"clusters K={K}: the model with a 3xTF32 cross term "
          f"{_rel(got, jax_mxu):.2e} of max|a| from JAX")
    assert _rel(got, jax_mxu) > 2e-3


# ---------------------------------------------------------------------------
# (d) the plan and the launcher's checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gsz", [32, 64, 96, 128, 256, 512, 1024])
def test_mxu_plan_is_an_instance_of_the_kernel(gsz):
    contraction, n, heavy = ek.mxu_plan(gsz)
    assert n in ek.MXU_CONTRACTIONS[contraction] and heavy in (True, False)
    ek._check_mxu(gsz, contraction, n)               # does not raise
    if contraction == "fma":
        assert gsz % (32 * n) == 0
    assert ek.mxu_plan(256) == ek._MXU_PLAN[256]


def _mxu_args(gsz, ng=2):
    return (torch.zeros(3, ng * gsz), torch.zeros(ng * gsz),
            torch.zeros(ng, 8, 16), torch.zeros(ng, dtype=torch.int32), None,
            0, 0.02)


_MXU_KW = dict(G=1.0, softening=1.0, window_groups=1, tau_clamp=24.0,
               far_tile=16)


@pytest.mark.parametrize("gsz,contraction,n,match", [
    (40, "mma", 2, "multiple of 16"),
    (72, "mma", 4, "multiple of 16"),
    (2048, "mma", 2, "up to 1024"),
    (64, "mma", 1, "takes"),
    (64, "fma", 3, "takes"),
    (48, "fma", 1, "multiple of 32"),
    (64, "fma", 4, "multiple of 128"),
    (64, "wgmma", 2, "not one of"),
    (64, "mma", 2, "unsupported device"),
    (48, "mma", 4, "unsupported device"),
    (128, "fma", 4, "unsupported device"),
])
def test_mxu_launch_checks(gsz, contraction, n, match):
    """An instance the group size does not allow raises before any launch
    (the tensor-core instance needs m16 tiles of targets); an allowed one
    raises here only for the CPU tensors."""
    before = ek.window_eval_mxu.launches
    with pytest.raises(ValueError, match=match):
        ek.mxu_launch(*_mxu_args(gsz), group_size=gsz, targets=n,
                      contraction=contraction, **_MXU_KW)
    assert ek.window_eval_mxu.launches == before


def test_window_eval_mxu_takes_the_plain_version_on_the_cpu():
    args = _mxu_args(64)
    before = ek.window_eval_mxu.launches
    got = ek.window_eval_mxu(*args, group_size=64, **_MXU_KW)
    want = ek.window_eval_mxu_reference(*args, group_size=64, **_MXU_KW)
    assert torch.equal(got, want)
    assert ek.window_eval_mxu.launches == before


def test_mxu_order_is_heavy_first_over_whole_tiles():
    far_n = torch.tensor([1, 40, 17, 0], dtype=torch.int32)
    order = ek._mxu_order(far_n, None, 64, (48, 16))
    assert order.tolist() == [1, 2, 0, 3]          # 48, 32, 16, 0 slots


# ---------------------------------------------------------------------------
# The tool's labels and HMMA counts
# ---------------------------------------------------------------------------

MXU_SASS = """
		Function : _ZN12_GLOBAL__N_126window_eval_mxu_mma_kernelILi10ELi2ELi\
256EEEvPKfS2_S2_PKiS4_S4_Pfiiiiiiiffff
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   MUFU.RSQ R10, R9 ;
        /*0020*/                   MUFU.RSQ R11, R9 ;
        /*0030*/                   HMMA.1688.F32.TF32 R12, R4, R8, R12 ;
        /*0040*/                   HMMA.1688.F32.TF32 R12, R6, R8, R12 ;
        /*0050*/                   FADD R3, R3, R5 ;
        /*0060*/               @P0 BRA 0x0 ;
        /*0070*/                   EXIT ;
""".replace("\\\n", "")


def test_eval_tiles_names_and_counts_the_mxu_instances(monkeypatch):
    tile = ("_ZN12_GLOBAL__N_127window_eval_mxu_tile_kernelILi10ELi2EEEvPKf"
            "S2_S2_PKiS4_S4_Pfiiiiiiiffff")
    big = ("_ZN12_GLOBAL__N_126window_eval_mxu_mma_kernelILi8ELi2ELi1024EEEv"
           "PKf")
    old = "_ZN12_GLOBAL__N_122window_eval_mxu_kernelILi10ELi256EEEvPKfS1_"
    assert eval_tiles.instance(tile) == "mxu R=10 fma T=2"
    assert eval_tiles.instance(big) == "mxu R=8 mma M=2 (<=1024 threads)"
    assert eval_tiles.instance(old, previous=True) == \
        "mxu R=10 (previous, <=256 threads)"
    assert eval_tiles.instance(old) is None
    assert "window_eval_mxu.cu" in eval_tiles.PARENT_SIGNATURES
    monkeypatch.setattr(eval_tiles, "_disassemble",
                        lambda path: eval_tiles.parse_sass(MXU_SASS))
    assert eval_tiles.sass_table("lib")["mxu R=10 mma M=2"][0] == 3.5
    assert eval_tiles.hmma_table("lib") == {"mxu R=10 mma M=2": 1.0}
