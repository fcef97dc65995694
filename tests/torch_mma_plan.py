"""The GF kernel's mma design sizes, restated from csrc/gf_bitmatrix.cu.

The C entry point plans the mma design's row groups itself
(``mma_group_tiles``, read through ``gf_kernel.row_groups`` on a card);
this is the same plan in Python, for the numpy model of the design
(test_torch_mma_model.py), the CPU tests of the plan, and the card's test
that holds the C plan against it (test_torch_gpu.py). It imports neither
the port nor JAX.
"""

MMA_WARPS = 8            # warps a block (kMmaWarps)
MMA_REG_TILES = 16       # K-tiles a warp holds for a whole unit
H100_OPTIN = 232448      # shared_memory_per_block_optin of an H100


def k_tiles(cols: int) -> int:
    """K-tiles (32 input bits each) of a k*w = `cols` product."""
    return -(-cols // 32)


def step(cols: int) -> int:
    """N-tiles a warp accumulates at once (mma_step): a group's N-tiles
    are a multiple of it."""
    return 4 if k_tiles(cols) <= MMA_REG_TILES else 8


def mma_smem(cols: int, group_tiles: int) -> int:
    """Dynamic shared memory of a block: the group's N-tiles (256 bytes a
    K-tile, K-tiles in pairs) beside two data tiles a warp (128 bytes a
    K-tile each)."""
    kt = k_tiles(cols)
    return 256 * (-(-kt // 2) * 2 * group_tiles + kt * MMA_WARPS)


def group_tiles(rows: int, cols: int, optin: int) -> int:
    """N-tiles a group stages (mma_group_tiles): as few groups as `optin`
    bytes allow, balanced, each a multiple of :func:`step`; 0 where one
    smallest group does not fit or the groups pass 65535."""
    s, fixed = step(cols), mma_smem(cols, 0)
    if optin < fixed:
        return 0
    most = (optin - fixed) // (mma_smem(cols, 1) - fixed) // s * s
    if most < s:
        return 0
    tiles = max(rows // 8, 1)
    groups = -(-tiles // most)
    if groups > 65535:
        return 0
    return -(-(-(-tiles // groups)) // s) * s


def row_groups(rows: int, cols: int, optin: int) -> list[tuple[int, int]]:
    """The (start, stop) rows of each group; ValueError where the kernel
    refuses the geometry."""
    tiles = group_tiles(rows, cols, optin)
    if tiles == 0:
        raise ValueError("k*w=%d: no row group fits %d bytes of shared "
                         "memory" % (cols, optin))
    span = 8 * tiles
    return [(r, min(r + span, rows)) for r in range(0, rows, span)] or \
        [(0, rows)]


def max_k(w: int, optin: int) -> int:
    """The most data rows at `w` one launch takes (gf_bitmatrix_max_k)."""
    k = 0
    while group_tiles(8, (k + 1) * w, optin):
        k += 1
    return k
