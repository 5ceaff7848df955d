"""The Python logic around the register-tiled window-eval kernels, on the
CPU: the table of targets a thread (T), the heavy-first launch order, the
launchers' refusal of CPU tensors, and the SASS reading of
``tools/eval_tiles.py`` on a sample of ``cuobjdump -sass`` output.
"""

import pytest
import torch

from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
from spatialsim_tpu_torch.tools import eval_tiles


@pytest.mark.parametrize("gsz", [1, 6, 50, 64, 100, 128, 256, 512, 1000,
                                 1024])
@pytest.mark.parametrize("rows", [8, 10, 13, 16])
def test_tile_targets_divide_the_group(gsz, rows):
    t = ek.tile_targets(gsz, rows)
    assert t in (1, 2, 4) and gsz % t == 0       # the kernels' instances
    if gsz != 1024:
        assert t == (2 if gsz % 2 == 0 else 1)


def test_tile_targets_table():
    """The measured table: 2 targets a thread at group 256 (the 1M
    configurations, pool and dense), 4 for the monopole rows at group 1024
    (the 50M preset), 2 for quadrupole rows."""
    assert [ek.tile_targets(256, r) for r in (8, 10, 13, 16)] == [2] * 4
    assert [ek.tile_targets(1024, r) for r in (8, 10, 13, 16)] == \
        [4, 4, 2, 2]


def test_heavy_first_order():
    far_n = torch.tensor([3, 9, 0, 9, 5, 3, 12], dtype=torch.int32)
    order = ek.heavy_first(far_n)
    assert order.dtype == torch.int32
    assert order.tolist() == [6, 1, 3, 4, 0, 5, 2]      # ties by group id
    assert sorted(order.tolist()) == list(range(7))


def test_heavy_first_counts_near_groups():
    """A near id in range adds a group of sources; -1 and ids >= ng add
    nothing."""
    far_n = torch.tensor([10, 40, 30, 0], dtype=torch.int32)
    near = torch.tensor([[1, -1], [-1, -1], [7, 4], [0, 1]],
                        dtype=torch.int32)
    assert ek.heavy_first(far_n, near, 16).tolist() == [1, 3, 2, 0]


def test_order_cache_sorts_once_per_lists():
    cache = ek._OrderCache()
    far_n = torch.tensor([1, 5, 3], dtype=torch.int32)
    first = cache(far_n)
    assert first.tolist() == [1, 2, 0] and cache(far_n) is first
    assert cache(far_n.clone()) is not first          # new lists
    far_n[0] = 9                                        # changed in place
    assert cache(far_n).tolist() == [0, 1, 2]
    near = torch.tensor([[-1], [-1], [0]], dtype=torch.int32)
    assert cache(far_n, near, 8).tolist() == [2, 0, 1]   # 3 + 8 > 9
    assert cache(far_n).tolist() == [0, 1, 2]


def test_launchers_refuse_cpu_tensors():
    s_pos = torch.zeros(3, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        ek.pool_launch(s_pos, torch.zeros(64), torch.zeros(1, 16, 8),
                       torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32), 0, 0.02, G=1.0,
                       softening=1.0, group_size=64, window_groups=2,
                       tau_clamp=24.0, targets=4)
    with pytest.raises(ValueError, match="unsupported device"):
        ek.dense_launch(s_pos, torch.zeros(64), torch.zeros(1, 8, 8),
                        torch.zeros(1, dtype=torch.int32), None, 0, 0.02,
                        G=1.0, softening=1.0, group_size=64,
                        window_groups=2, tau_clamp=24.0, targets=4)


SASS = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _ZN52_GLOBAL__N__72e7bdf0_19_window_eval_pool_cu_f8b83039\
23window_eval_pool_kernelILi2EEEvPKfS2_S2_PKiS4_S4_Pfiiiiiffff
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/             LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                      /* 0x000fe40000000800 */
        /*0010*/                   LDS.128 R4, [UR7+-0x40] ;
        /*0020*/                   FADD R8, -R20, R4 ;
        /*0030*/                   FFMA R9, R8, R8, UR22 ;
        /*0040*/                   MUFU.RSQ R10, R9 ;
        /*0050*/                   MUFU.RSQ R11, R9 ;
        /*0060*/                   NOP ;
        /*0070*/               @P0 BRA 0x10 ;
        /*0080*/                   MUFU.RSQ R12, R9 ;
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00a0*/              @!P1 BRA 0x0 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   BRA 0xc0;
		Function : _ZN47_GLOBAL__N__f1ef1629_14_window_eval_cu_411af66518\
window_eval_kernelILi16ELi2EEEvPKfS2_S2_PKiS4_Pfiiiiiffff
        /*0000*/                   MUFU.RSQ R10, R9 ;
        /*0010*/               @P0 BRA 0x0 ;
        /*0020*/                   EXIT ;
""".replace("\\\n", "")


def test_sass_inner_loops_and_labels():
    """The innermost loop with a MUFU.RSQ: head to back branch, NOPs not
    counted (6 instructions over 2 MUFU.RSQ); the outer loop and the
    self-branch after EXIT are not innermost or hold no MUFU.RSQ."""
    funcs = eval_tiles.parse_sass(SASS)
    assert len(funcs) == 2
    pool, dense = funcs
    assert eval_tiles.inner_loops(funcs[pool]) == [(0x10, 0x70, 6, 2)]
    assert eval_tiles.inner_loops(funcs[dense]) == [(0x0, 0x10, 2, 1)]
    assert eval_tiles.instance(pool) == "pool T=2"
    assert eval_tiles.instance(pool, previous=True) == "pool (previous)"
    assert eval_tiles.instance(dense) == "dense R=16 T=2"
    assert eval_tiles.instance(dense, previous=True) == \
        "dense R=16 (previous, <=2 threads)"
    assert eval_tiles.instance("_ZN12window_eval_cols_kernelILi8EEEv") is None


BOIDS_SASS = """
		Function : _ZN12_GLOBAL__N_119boids_window_kernelILi1ELb1ELb0EEEvPKfS2_\
S2_S2_Pfiiifff
        /*0000*/                   MOV R0, R1 ;
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/                   FSETP.GEU.AND P0, PT, R2, UR6, PT ;
        /*0030*/               @P0 BRA 0xa0 ;
        /*0040*/                   LDS.128 R4, [R8] ;
        /*0050*/                   FADD R4, -R4, R9 ;
        /*0060*/                   NOP ;
        /*0070*/                   SEL R5, RZ, 0x1, !P2 ;
        /*0080*/              @!P0 BRA 0xa0 ;
        /*0090*/                   LDS.64 R10, [R9] ;
        /*00a0*/                   IADD3 R1, R1, 0x1, RZ ;
        /*00b0*/              @!P1 BRA 0x10 ;
        /*00c0*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_119boids_window_kernelEPKfS1_S1_S1_Pfiiifff
        /*0000*/                   MOV R0, R1 ;
        /*0010*/                   LDS.128 R12, [UR7] ;
        /*0020*/                   FADD R2, R31, -R12 ;
        /*0030*/                   FSETP.GT.AND P1, PT, R18, 1e-4, PT ;
        /*0040*/               @P1 BRA 0x70 ;
        /*0050*/                   LDS.64 R16, [R36] ;
        /*0060*/                   FADD R0, R0, 1 ;
        /*0070*/                   LDS.128 R12, [UR7+0x10] ;
        /*0080*/                   FADD R2, R31, -R12 ;
        /*0090*/               @P1 BRA 0xc0 ;
        /*00a0*/                   LDS.64 R16, [R36+0x8] ;
        /*00b0*/                   FADD R0, R0, 1 ;
        /*00c0*/               @P3 BRA 0x10 ;
        /*00d0*/                   EXIT ;
""".replace("\\\n", "")


def test_boids_sass_counts():
    """The redesigned kernel: the longest basic block is the test block
    (4 instructions, NOP not counted, over 32 pairs at T=1); a tested
    chunk walks the cull (not taken), the block and the taken neighbour
    skip to the loop's tail (9); a culled chunk 5.  The previous kernel:
    the no-neighbour path over its LDS.128 loads (8 over 2)."""
    funcs = eval_tiles.parse_sass(BOIDS_SASS)
    new, old = funcs
    assert eval_tiles.instance(new) == "boids T=1 cull on pass 1"
    assert eval_tiles.instance(old, previous=True) == "boids (previous)"
    rec = eval_tiles.boids_counts(funcs[new], 1)
    assert rec["test"] == 4 / 32 and rec["pair"] == 9 / 32
    assert rec["skipped"] == 5 and rec["loop"] == (0x10, 0xb0)
    rec = eval_tiles.boids_counts(funcs[old])
    assert rec["pair"] == 4.0 and rec["test"] is None
    assert rec["loop"] == (0x10, 0xc0)
    assert eval_tiles.instance(
        "_ZN12_GLOBAL__N_115allpairs_kernelILi2EEEvPKfS2_Pfiiff") == \
        "allpairs T=2"
    assert eval_tiles.instance("_Z15allpairs_kernelPKfS0_Pfiff",
                               previous=True) == "allpairs (previous)"
