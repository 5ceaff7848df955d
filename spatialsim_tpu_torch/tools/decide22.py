"""The primitives of a dense level-synchronous traversal, priced before
such a traversal is built (port of ``scripts/decide22.py``).

    python -m spatialsim_tpu_torch.tools.decide22 [--C 262144] [--CP 65536]
        [--G 3907] [--L 6144] [--B 256] [--emit 4200000]
        [--pool-idx 6500000] [--widths 2097152 4194304]
        [--seg-width 4194304] [--slices 32768] [--device cuda|cpu]

The script fixes its sizes at module level (the 1M galaxy's level 8: C
occupied-cell slots x G groups, its parent level's CP, list cap L, rank
block B, EMIT emitted entries); here they are flags with those
defaults.  Chained marginals (:mod:`~spatialsim_tpu_torch.tools.chain`:
host clock and device time) of 1. the fused acceptance pass over (C, G)
to an int8 mask, 2. the parent-row gather ``(CP, G)[ptr]``, 3a/3b. the
intra-block rank by cumulative sum and by a bfloat16 matrix product with
a triangular matrix, 4. the block-base cumulative sum, 5. the emitted
entries' two-column scatter into ``(G * L,)``, 6. the pool-fill packed
gather ``(14, G*L)[:, idx]``, 7. flat and hierarchical cumulative sums
at each width, 8. a segment sum at ``--seg-width`` (the port's float
form, ``octree._segment``), 9. the int8 transpose, 10. (1, 128) int8 row
slices at ``--slices`` block starts and 11. (10, 128) float32 attribute
slices.  The data come from numpy's ``default_rng`` (the script's are
JAX's PRNG).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.ops.octree import _segment
from spatialsim_tpu_torch.tools.chain import marginal
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import device_of

SIZES = dict(C=262_144, CP=65_536, G=3_907, L=6_144, B=256,
             emit=4_200_000, pool_idx=6_500_000,
             widths=(1 << 21, 1 << 22), seg_width=1 << 22, slices=32_768)


def run(C, CP, G, L, B, emit, pool_idx, widths, seg_width, slices,
        device="cuda", out=print):
    """The primitives; returns ``{label: Marginal}``."""
    out(f"platform={device.type} C={C} G={G} B={B}", flush=True)
    rng = np.random.default_rng(0)

    def put(a):
        return torch.as_tensor(a, device=device)

    ccom = put((rng.standard_normal((3, C)) * 500.0).astype(np.float32))
    crng = torch.stack([torch.arange(C, device=device) * 4,
                        torch.arange(C, device=device) * 4 + 4])
    gb = put((rng.standard_normal((6, G)) * 500.0).astype(np.float32))
    iv = torch.stack([torch.arange(G, device=device) * 256,
                      torch.arange(G, device=device) * 256 + 1280])
    parent_open = put((rng.random((CP, G), np.float32) < 0.05)
                      .astype(np.int8))
    ptr = put(np.sort(rng.integers(0, CP, C)))

    def accept():
        # Per-axis 2D expressions, every temporary (C, G) at most.
        d2 = torch.full((C, G), 4.0, device=device)
        for ax in range(3):
            c = ccom[ax][:, None]
            gap = torch.clamp(torch.maximum(gb[ax][None, :] - c,
                                            c - gb[3 + ax][None, :]), min=0.0)
            d2 += gap * gap
        cs, ce = crng[0][:, None], crng[1][:, None]
        lo, hi = iv[0][None, :], iv[1][None, :]
        outside = ~((cs >= lo) & (ce <= hi)) & ~((cs < hi) & (ce > lo))
        return (outside & (4.3 * 4.3 < 0.64 * d2)).to(torch.int8)

    res = {}

    def case(label, fn, per=0):
        res[label] = m = marginal(fn, device)
        # Per element, as the script prints it for the flat widths.
        ns = f"{m.host / per * 1e6:.4f} ns/el, " if per else ""
        out(f"  {label}: {m.host:.3f} ms ({ns}t1 {m.t1:.3f}); "
            f"{m.dev_text()}", flush=True)

    case("accept pass (C,G)", accept)
    emit_mask = accept()
    case("parent row-gather (CP,G)[ptr]", lambda: parent_open[ptr])
    eb = emit_mask.reshape(C // B, B, G)
    case("rank cumsum (C/B,B,G) i32",
         lambda: torch.cumsum(eb.to(torch.int32), 1, dtype=torch.int32))
    lt = torch.tril(torch.ones((B, B), dtype=torch.bfloat16, device=device))
    case("rank matmul bf16 (B,B)x(.,B,G)",
         lambda: torch.matmul(lt, eb.to(torch.bfloat16)).float())
    bc = eb.to(torch.int32).sum(1, dtype=torch.int32)
    case("block-base cumsum (C/B,G)",
         lambda: torch.cumsum(bc, 0, dtype=torch.int32))

    flat_idx = put(rng.integers(0, G * L, emit))
    vals = torch.arange(emit, dtype=torch.int32, device=device)

    def scatter():
        a = torch.zeros((G * L + 1,), dtype=torch.int32, device=device)
        b = torch.zeros((G * L + 1,), dtype=torch.int32, device=device)
        a[flat_idx] = vals
        b[flat_idx] = vals + 1
        return a, b

    case(f"entry scatter 2x{emit / 1e6:.1f}M", scatter)
    table = put(rng.standard_normal((14, G * L + 1), np.float32))
    pidx = put(rng.integers(0, G * L, pool_idx))
    case(f"pool packed gather {pool_idx / 1e6:.1f}M idx",
         lambda: table[:, pidx])
    del table, pidx, flat_idx, vals

    for w in widths:
        x = put((rng.random(w) < 0.3).astype(np.int32))
        case(f"flat cumsum W={w}",
             lambda x=x: torch.cumsum(x, 0, dtype=torch.int32), w)
        lt512 = torch.tril(torch.ones((512, 512), dtype=torch.bfloat16,
                                      device=device), diagonal=-1)

        def hier(x=x, w=w, lt512=lt512):
            xb = x.reshape(w // 512, 512)
            bs = xb.sum(1)
            bb = torch.cumsum(bs, 0) - bs
            r = torch.matmul(xb.to(torch.bfloat16), lt512).float()
            return (r + bb[:, None].float()).to(torch.int32).reshape(w)

        case(f"hier cumsum W={w}", hier, w)

    gidx = put(np.sort(rng.integers(0, G, seg_width)))
    ones = torch.ones((seg_width,), dtype=torch.float32, device=device)
    case(f"segment_sum W={seg_width}", lambda: _segment(ones, gidx, G),
         seg_width)
    case("int8 transpose (C,G)", lambda: emit_mask.T.contiguous())

    emit_t = emit_mask.T.contiguous()
    bidx = put(rng.integers(0, C // 128, slices))
    gsel = put(rng.integers(0, G, slices))
    cols = bidx[:, None] * 128 + torch.arange(128, device=device)
    case(f"(1,128) slice-gather {slices // 1024}K",
         lambda: emit_t[gsel[:, None], cols])
    attrs = put(rng.standard_normal((10, C), np.float32))
    case(f"(10,128) attr-slice gather {slices // 1024}K",
         lambda: attrs[:, cols])
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for k in ("C", "CP", "G", "L", "B", "emit", "seg_width", "slices"):
        ap.add_argument("--" + k.replace("_", "-"), type=int,
                        default=SIZES[k])
    ap.add_argument("--pool-idx", type=int, default=SIZES["pool_idx"])
    ap.add_argument("--widths", type=int, nargs="+",
                    default=list(SIZES["widths"]))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide22")
    print(device_line(dev), flush=True)
    run(a.C, a.CP, a.G, a.L, a.B, a.emit, a.pool_idx, a.widths,
        a.seg_width, a.slices, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
