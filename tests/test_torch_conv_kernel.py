"""K5's launch plan (``_k5_route``) and tile walk, computed on the CPU.

The kernel runs only on the card: ``test_torch_cuda.py`` holds every route
against the plain version there, and ``test_torch_conv.py`` holds the plain
version against the Pallas ``conv1x1_s2_dgrad`` in interpret mode. Here the
plan that the wrapper passes to the kernel is checked from the shape alone:
which route, how wide a tile, how many blocks, how much shared memory, and
the order in which the persistent blocks walk the tiles.
"""
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import conv_kernel
from mxnet_tpu_torch.ops.conv_kernel import _k5_route, _k5_walk

SMS = 132             # an H100's SMs
SMEM_LIMIT = 232448   # the shared memory a Hopper block may opt in to
# the six stride-2 1x1 convs of a ResNet-50 v1 step at batch 128,
# (N, Ho, Wo, K, C): stages 2-4, body conv1 (K = C / 2) and downsample
# (K = 2C)
SITES = [(128, ho, ho, k, c) for ho, c in ((28, 256), (14, 512), (7, 1024))
         for k in (c // 2, 2 * c)]
SITES_B8 = [(8,) + s[1:] for s in SITES]
# bf16 shapes whose K or C is not a multiple of 8 (TMA's 16-byte row
# strides), and an empty K
RAGGED = [(3, 5, 3, 40, 134), (2, 3, 3, 12, 64), (1, 1, 1, 8, 100),
          (4, 7, 7, 60, 100), (1, 2, 2, 0, 8)]


def _tiles(m, c, bm, bn):
    return -(-m // bm), -(-c // bn)


@pytest.mark.parametrize("shape", SITES + SITES_B8)
def test_resnet_sites_take_the_wgmma_route(shape):
    n, ho, wo, k, c = shape
    plan = _k5_route(*shape, torch.bfloat16, SMS)
    assert plan.route == "wgmma" and plan.bn in (128, 256)
    assert (plan.row_tiles, plan.col_tiles) == _tiles(n * ho * wo, c, 128,
                                                      plan.bn)
    assert plan.grid == min(SMS, plan.row_tiles * plan.col_tiles)
    assert plan.stages == conv_kernel._WGMMA_STAGES[plan.bn]
    assert plan.smem == conv_kernel._wgmma_smem(plan.bn)


@pytest.mark.parametrize("shape,bn", list(zip(SITES,
                                              (256, 256, 256, 256, 128, 128))))
def test_tile_width_follows_the_waves(shape, bn):
    # stages 2 and 3: 784 and 392 wide tiles fill 132 SMs as well as twice
    # as many narrow ones, and wide tiles read w2 half as often; stage 4:
    # 196 wide tiles are two waves (the second half full), 392 narrow ones
    # three full half-size waves
    assert _k5_route(*shape, torch.bfloat16, SMS).bn == bn


@pytest.mark.parametrize("shape", RAGGED)
def test_shapes_tma_cannot_address_take_the_wmma_route(shape):
    n, ho, wo, k, c = shape
    plan = _k5_route(*shape, torch.bfloat16, SMS)
    assert plan.route == "wmma"
    assert (plan.bn, plan.stages, plan.smem) == (64, 1, 0)
    assert (plan.row_tiles, plan.col_tiles) == _tiles(n * ho * wo, c, 128, 64)
    assert plan.grid == plan.row_tiles * plan.col_tiles


@pytest.mark.parametrize("shape", SITES[:2] + RAGGED[:2] + [(3, 5, 3, 40,
                                                             136)])
def test_f32_takes_the_cuda_core_route(shape):
    n, ho, wo, k, c = shape
    plan = _k5_route(*shape, torch.float32, SMS)
    assert plan.route == "f32"
    assert (plan.bn, plan.stages, plan.smem) == (64, 1, 0)
    assert plan.grid == plan.row_tiles * plan.col_tiles == (
        -(-n * ho * wo // 64) * -(-c // 64))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_are_refused(dtype):
    with pytest.raises(MXNetError, match="f32 or bf16"):
        _k5_route(2, 3, 3, 64, 64, dtype, SMS)


@pytest.mark.parametrize("bn,smem", [(128, 199776), (256, 216128)])
def test_plan_shared_memory_fits_a_block(bn, smem):
    # k5::Layout<BN>::kBytes: the ring, the staging tile, the mbarriers,
    # the consumers' tile count and 1024 bytes to align the swizzled tiles
    assert conv_kernel._wgmma_smem(bn) == smem <= SMEM_LIMIT


@pytest.mark.parametrize("shape", SITES + SITES_B8 + [(3, 5, 3, 40, 136),
                                                      (1, 1, 1, 8, 8)])
def test_tile_walk_covers_every_tile_once(shape):
    plan = _k5_route(*shape, torch.bfloat16, SMS)
    walk = _k5_walk(plan)
    assert len(walk) == plan.grid
    tiles = [t for block in walk for t in block]
    assert sorted(tiles) == [(r, c) for r in range(plan.row_tiles)
                             for c in range(plan.col_tiles)]
    # every block gets its share of the tiles, within one
    sizes = {len(block) for block in walk}
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


@pytest.mark.parametrize("shape", SITES + [(3, 5, 3, 40, 136)])
def test_tile_walk_keeps_a_row_tiles_columns_adjacent(shape):
    # in launch order (the i-th tile of every block, block by block) the
    # column tiles of one row tile follow each other, so the blocks that
    # share a row tile of dy run side by side
    plan = _k5_route(*shape, torch.bfloat16, SMS)
    walk = _k5_walk(plan)
    order = [block[i] for i in range(max(map(len, walk)))
             for block in walk if i < len(block)]
    assert order == sorted(order)
    for row in range(plan.row_tiles):
        at = [i for i, (r, _) in enumerate(order) if r == row]
        assert at == list(range(at[0], at[0] + plan.col_tiles))


def test_plan_uses_the_card_it_is_given():
    small = _k5_route(*SITES[0], torch.bfloat16, 16)
    assert small.grid == 16
    assert _k5_route(1, 1, 1, 8, 8, torch.bfloat16, SMS).grid == 1


def test_aligned_copies_only_unaligned_views():
    base = torch.arange(64, dtype=torch.float32).bfloat16()
    assert conv_kernel._aligned(base) is base
    view = base[1:33]
    assert view.data_ptr() % 16 != 0
    copy = conv_kernel._aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


def test_cpu_tensors_launch_nothing():
    before = (conv_kernel.conv1x1_s2_dgrad.launches,
              dict(conv_kernel.conv1x1_s2_dgrad.launches_by_route))
    dy = torch.ones(1, 2, 2, 8, dtype=torch.bfloat16)
    dx = conv_kernel.conv1x1_s2_dgrad(dy, torch.ones(8, 8,
                                                     dtype=torch.bfloat16),
                                      4, 4)
    assert dx.shape == (1, 4, 4, 8) and float(dx[0, 0, 0, 0]) == 8.0
    assert (conv_kernel.conv1x1_s2_dgrad.launches,
            conv_kernel.conv1x1_s2_dgrad.launches_by_route) == before
