"""The CUDA kernels against their plain PyTorch versions on the card, at
small and ragged shapes (the main-path shapes are in ``chip_smoke.py``).

Needs an NVIDIA card; skipped without one.  The tests directory's
conftest imports JAX, which the card's machine does not have, so run:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances are chip_smoke's: the gather is bit-exact; the f32 segment-sum
1e-5; bf16 one rounding of an f32 sum (rtol 2^-7), and bit-exact on
integer features (sums of small integers are exact in any order) and
against the serial f32 sum in point order (its own arithmetic); the GRU f32 1e-4 and
bf16 rtol 2^-6 / atol 4e-3.  The backward kernels (GRU backward, CBG
forward and backward) are held relative to the largest reference element:
2e-5 in f32, 2^-6 in bf16.  The SSL kernels: the lane segment-sum 1e-6 of
the largest element against the plain version on the card (its
index_add_ adds in another order, with atomics), bit for bit against the
CPU's serial one; the cell sweep and the brute search bit-exact (one
rounding per operation on both sides, the same tie rules).
"""

import numpy as np
import pytest
import torch

from deflow_tpu_torch.ops import gather, gru, nn, scatter

pytestmark = pytest.mark.cuda

DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _plan(g, sizes, num_segments, dev):
    """Flat ids like the presorted plan: per sample ascending ids, trash
    tails mapped to the sentinel, samples offset by num_segments."""
    parts = []
    sentinel = scatter.sentinel_for(len(sizes) * num_segments)
    for b, (n, n_valid) in enumerate(sizes):
        ids = torch.randint(0, num_segments - 8, (n_valid,), generator=g).sort().values
        parts += [ids + b * num_segments,
                  torch.full((n - n_valid,), sentinel, dtype=torch.int64)]
    return torch.cat(parts).to(torch.int32).to(dev)


def _serial_segment_sum(feats, ids, s):
    """The kernel's own arithmetic on the host: each row summed in f32 from
    0 in ascending point order (numpy, one add at a time), rounded once to
    the input dtype."""
    x, i = feats.float().cpu().numpy(), ids.cpu().numpy()
    out = np.zeros((s, x.shape[1]), np.float32)
    for j in np.flatnonzero((i >= 0) & (i < s)):
        out[i[j]] = out[i[j]] + x[j]
    return torch.from_numpy(out).to(feats.dtype)


def _held_segment_sum(feats, ids, s, samples=1, plain_tol=True):
    """The kernel bit for bit against the serial sum in its own arithmetic
    and, on integer features (values in {-1, 0, 1}: exact sums in any
    order), against its plain version; on the given features within the
    plain version's tolerance (``plain_tol``: index_add_ adds in another
    order); exact zeros in the empty rows.  Returns the kernel's output."""
    assert scatter.plan_is_sorted(ids, s, samples)
    dtype = feats.dtype
    k = scatter.sorted_segment_sum(feats, ids, s, samples)
    g = torch.Generator().manual_seed(ids.shape[0])
    ints = torch.randint(-1, 2, feats.shape, generator=g).to(feats.device, dtype)
    ki = scatter.sorted_segment_sum(ints, ids, s, samples)
    torch.cuda.synchronize()
    assert k.shape == (s, feats.shape[1]) and k.dtype == dtype
    assert torch.equal(k.cpu(), _serial_segment_sum(feats, ids, s))
    if plain_tol:
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-6)
        torch.testing.assert_close(k.float(), scatter.segment_sum_plain(feats, ids, s).float(),
                                   rtol=rtol, atol=atol)
    assert torch.equal(ki, scatter.segment_sum_plain(ints, ids, s))
    empty = torch.ones(s, dtype=torch.bool, device=feats.device)
    empty[ids[(ids >= 0) & (ids < s)].long()] = False
    assert (k[empty] == 0).all()
    return k


@pytest.mark.parametrize("samples", [1, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [1, 5, 33, 64, 128])
def test_segment_sum(dev, dtype, c, samples):
    """Four samples of 600 points (one all sentinel, one with 120 points in
    one pillar), or one of 2,400 with a sentinel tail; 308 rows a sample,
    so tiles and samples start mid-chunk."""
    g = torch.Generator().manual_seed(10 * c + samples)
    seg = 300 + 8
    if samples == 4:
        ids = _plan(g, [(600, 550), (600, 0), (600, 600), (600, 120)], seg, dev)
        ids[1800:1920] = 3 * seg + 17       # the last sample's points in one pillar
    else:
        ids = _plan(g, [(2400, 2000)], 4 * seg, dev)
    feats = torch.randn(ids.shape[0], c, generator=g).to(dev, dtype)
    _held_segment_sum(feats, ids, 4 * seg, samples)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [33, 128])
def test_segment_sum_dense_pillar_and_empty_tiles(dev, dtype, c):
    """5,000 points in one pillar (more than a tile stages at once, at
    either width), a few sparse pillars, and whole tiles with no point, in
    two samples.  Sums of 5,000 f32 terms in index_add_'s order differ from
    the point order by more than 1e-5, so the random features are held bit
    for bit to the serial sum only."""
    seg = 20000
    parts = []
    for b in range(2):
        ids = torch.cat([torch.tensor([3, 3, 70]), torch.full((5000,), 4100 + b),
                         torch.tensor([4101 + b, 15000, 19991]),
                         torch.full((997,), 2 * seg + 1)])
        parts.append(torch.where(ids < seg, ids + b * seg, ids))
    ids = torch.cat(parts).to(torch.int32).to(dev)
    g = torch.Generator().manual_seed(c)
    feats = torch.randn(ids.shape[0], c, generator=g).to(dev, dtype)
    k = _held_segment_sum(feats, ids, 2 * seg, 2, plain_tol=False)
    assert (k[5000:14000] == 0).all()


@pytest.mark.parametrize("samples", [1, 4])
def test_segment_sum_all_sentinel_and_empty(dev, samples):
    feats = torch.ones(48, 3, device=dev)
    ids = torch.full((48,), scatter.sentinel_for(200), dtype=torch.int32,
                     device=dev)
    assert (scatter.sorted_segment_sum(feats, ids, 200, samples) == 0).all()
    none = scatter.sorted_segment_sum(feats[:0], ids[:0], 200, samples)
    assert none.shape == (200, 3) and (none == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_sum_repeats_and_replays(dev, dtype):
    """Two launches are bit-identical, and a CUDA graph of one call replays
    to the same output twice (nothing to reset between calls)."""
    g = torch.Generator().manual_seed(23)
    seg = 5000
    ids = _plan(g, [(3000, 2700), (3000, 2900)], seg, dev)
    feats = torch.randn(ids.shape[0], 33, generator=g).to(dev, dtype)
    first = scatter.sorted_segment_sum(feats, ids, 2 * seg, 2)
    again = scatter.sorted_segment_sum(feats, ids, 2 * seg, 2)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    before = scatter.sorted_segment_sum.launches
    for (out,) in _graph_replays(lambda: scatter.sorted_segment_sum(feats, ids, 2 * seg, 2)):
        assert torch.equal(out, first)
    assert scatter.sorted_segment_sum.launches == before + 2      # warm-up and capture


def test_segment_sum_refuses_bad_arguments(dev):
    feats = torch.ones(6, 4, device=dev)
    ids = torch.zeros(6, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="samples"):
        scatter.sorted_segment_sum(feats, ids, 10, 4)
    with pytest.raises(ValueError, match="beyond the kernel"):
        scatter.sorted_segment_sum(torch.ones(6, 4096, device=dev), ids, 10)


@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_sum_table_past_2_gib(dev, dtype):
    """Two samples of 128 lanes whose [S, 128] table passes 2^31 bytes (in
    f32 the gather's backward of four samples at the 1024^2 grid, 0.1 m
    pillars, is 2^31 bytes): rows past the 2^31-th byte are written where
    their points are and zero elsewhere, as below it."""
    g = torch.Generator().manual_seed(31)
    rows_2gib = 2 ** 31 // (128 * torch.empty((), dtype=dtype).element_size())
    seg = rows_2gib * 3 // 4            # 1.5 x 2^31 bytes in all
    ids = _plan(g, [(4000, 3500), (4000, 3900)], seg, dev)
    feats = torch.randn(ids.shape[0], 128, generator=g).to(dev, dtype)
    k = _held_segment_sum(feats, ids, 2 * seg, 2)
    high = (ids >= rows_2gib) & (ids < 2 * seg)
    assert high.sum() > 1000 and (k[ids[high].long()] != 0).any(-1).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_table_past_2_31_elements(dev, dtype):
    """A [2^24 + 64, 128] table (rows of whole 16-byte vectors): ids past
    the 2^31-th element read their rows, bit-exact."""
    g = torch.Generator().manual_seed(32)
    rows = 2 ** 24 + 64
    table = torch.empty(rows, 128, dtype=dtype, device=dev)
    table[: 2 ** 20].normal_(generator=torch.Generator(device=dev).manual_seed(1))
    table[-2 ** 20:].normal_(generator=torch.Generator(device=dev).manual_seed(2))
    ids = torch.cat([torch.randint(0, 2 ** 20, (500,), generator=g),
                     torch.randint(rows - 2 ** 20, rows, (1500,), generator=g),
                     torch.tensor([rows - 1, rows, 2 ** 30])]).sort().values
    ids = ids.to(torch.int32).to(dev)
    k = gather.sorted_rows_gather(table, ids, rows)
    assert table.numel() >= 2 ** 31
    assert torch.equal(k, gather.gather_plain(table, ids, rows))
    assert (k[-3] != 0).any() and (k[-2:] == 0).all()


def _gather_ids(g, rows, dev):
    """Ascending ids, then sentinels, out-of-range ids and unsorted ones."""
    return torch.cat([torch.randint(0, rows, (700,), generator=g).sort().values,
                      torch.full((13,), 2 ** 30), torch.tensor([-1, rows, 0]),
                      torch.randint(0, rows, (300,), generator=g)]
                     ).to(torch.int32).to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [1, 3, 8, 32, 33, 65, 128])
def test_gather_is_bit_exact(dev, dtype, c):
    g = torch.Generator().manual_seed(c)
    rows = 1000
    table = torch.randn(rows, c, generator=g).to(dev, dtype)
    ids = _gather_ids(g, rows, dev)
    k = gather.sorted_rows_gather(table, ids, rows)
    assert torch.equal(k, gather.gather_plain(table, ids, rows))
    short = gather.sorted_rows_gather(table, ids, rows // 2)
    assert torch.equal(short, gather.gather_plain(table, ids, rows // 2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [1, 3, 8, 33])
@pytest.mark.parametrize("m", [0, 1, 7])
def test_gather_edge_sizes(dev, dtype, c, m):
    """No ids, one id, and (m = 7 at c != 8) a flat output that is not a
    whole number of 16-byte chunks, its last id a sentinel."""
    g = torch.Generator().manual_seed(10 * m + c)
    rows = 50
    table = torch.randn(rows, c, generator=g).to(dev, dtype)
    ids = torch.randint(0, rows, (m,), generator=g).sort().values
    if m == 7:
        ids[-1] = 2 ** 30
    ids = ids.to(torch.int32).to(dev)
    k = gather.sorted_rows_gather(table, ids, rows)
    assert k.shape == (m, c) and k.dtype == dtype
    assert torch.equal(k, gather.gather_plain(table, ids, rows))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [8, 33, 128])
def test_gather_unaligned_table(dev, dtype, c):
    """Tables whose base is aligned to one element only: a row slice of a
    larger table (2-byte aligned in bf16 at c = 33) and a view that starts
    one element into its storage (16-byte rows at c = 8 and 128)."""
    g = torch.Generator().manual_seed(c + 1)
    rows = 300
    flat = torch.randn((rows + 1) * c + 1, generator=g).to(dev, dtype)
    ids = _gather_ids(g, rows, dev)
    for table in (flat[:(rows + 1) * c].view(rows + 1, c)[1:].contiguous(),
                  flat[1:1 + rows * c].view(rows, c)):
        assert table.is_contiguous()
        k = gather.sorted_rows_gather(table, ids, rows)
        assert torch.equal(k, gather.gather_plain(table, ids, rows))


@pytest.mark.parametrize("dtype,xdim", [(torch.float32, 3),
                                        (torch.float32, 64),
                                        (torch.float32, 100),
                                        (torch.bfloat16, 16),
                                        (torch.bfloat16, 64)])
@pytest.mark.parametrize("m", [1, 31, 32, 33, 63, 64, 65, 1000, 4229, 32 * 133 + 5,
                               64 * 133 + 5, 20000])
@pytest.mark.parametrize("iters", [0, 1, 2, 4, 6])
def test_fused_gru(dev, dtype, xdim, m, iters):
    """M at the edges of 32- and 64-point tiles (the f32 kernel's and the
    bf16 kernel's), just past a wave of 132 blocks of either, and at more
    tiles than the card has SMs (20,000: each block walks 2-3 tiles, so the
    prefetch buffers alternate); held to the plain version and bit for bit
    between two launches."""
    g = torch.Generator().manual_seed(m * 7 + xdim)
    k_in = 128 + xdim
    args = [torch.randn(m, 128, generator=g) * 0.5,
            torch.randn(m, xdim, generator=g) * 0.5,
            torch.randn(k_in, 256, generator=g) * 0.1,
            torch.randn(256, generator=g) * 0.1,
            torch.randn(k_in, 128, generator=g) * 0.1,
            torch.randn(128, generator=g) * 0.1]
    args = [a.to(dev, dtype).contiguous() for a in args]
    k = gru.fused_gru(*args, iters)
    again = gru.fused_gru(*args, iters)
    ref = gru.fused_gru_plain(*args, iters)
    torch.cuda.synchronize()
    assert torch.equal(k, again)
    assert k.shape == (m, 128) and k.dtype == dtype
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -6, 4e-3)
    torch.testing.assert_close(k.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_gru_rejects_unaligned(dev, dtype):
    """A contiguous h0 one element past 16-byte alignment: the wrapper
    raises rather than falling back to the plain version."""
    g = torch.Generator().manual_seed(5)
    args = _gru_bwd_args(g, 65, 64, dtype, dev)[:6]
    flat = torch.empty(65 * 128 + 1, dtype=dtype, device=dev)
    h0 = flat[1:].view(65, 128)
    h0.copy_(args[0])
    assert h0.is_contiguous() and h0.data_ptr() % 16
    before = gru.fused_gru.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        gru.fused_gru(h0, *args[1:], 4)
    assert gru.fused_gru.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_gru_is_deterministic(dev, dtype):
    """Two launches at M = 4,229 (a ragged last tile) agree bit for bit."""
    g = torch.Generator().manual_seed(19)
    args = _gru_bwd_args(g, 4229, 64, dtype, dev)[:6]
    first = gru.fused_gru(*args, 4)
    second = gru.fused_gru(*args, 4)
    want = gru.fused_gru_plain(*args, 4)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -6, 4e-3)
    torch.testing.assert_close(first.float(), want.float(), rtol=rtol, atol=atol)


def test_wrappers_count_launches(dev):
    feats = torch.ones(4, 2, device=dev)
    ids = torch.tensor([0, 0, 1, 5], dtype=torch.int32, device=dev)
    before = (scatter.sorted_segment_sum.launches,
              gather.sorted_rows_gather.launches)
    scatter.sorted_segment_sum(feats, ids, 3)
    gather.sorted_rows_gather(feats, ids, 4)
    assert (scatter.sorted_segment_sum.launches,
            gather.sorted_rows_gather.launches) == (before[0] + 1, before[1] + 1)


def _rel_err(k, ref):
    """max |k − ref| over max(1, max |ref|)."""
    k, ref = k.float(), ref.float()
    return ((k - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()


# f32: summation order only; bf16: one rounding of an f32 sum (a bf16 ulp is
# 2^-8 relative) plus rare flips of a rounded operand.
GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -6}


def _gru_bwd_args(g, m, xdim, dtype, dev):
    k_in = 128 + xdim
    args = [torch.randn(m, 128, generator=g) * 0.5,
            torch.randn(m, xdim, generator=g) * 0.5,
            torch.randn(k_in, 256, generator=g) * 0.1,
            torch.randn(256, generator=g) * 0.1,
            torch.randn(k_in, 128, generator=g) * 0.1,
            torch.randn(128, generator=g) * 0.1,
            torch.randn(m, 128, generator=g)]
    return [a.to(dev, dtype).contiguous() for a in args]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("xdim", [16, 64])
@pytest.mark.parametrize("m", [1, 31, 33, 1000])
@pytest.mark.parametrize("iters", [0, 1, 2, 4, 6])
def test_fused_gru_bwd(dev, dtype, xdim, m, iters):
    g = torch.Generator().manual_seed(m * 11 + xdim + iters)
    args = _gru_bwd_args(g, m, xdim, dtype, dev)
    got = gru.fused_gru_bwd(*args, iters)
    want = gru.fused_gru_bwd_plain(*args, iters)
    torch.cuda.synchronize()
    for name, k, ref in zip(("dh0", "dx", "dw_zr", "db_zr", "dw_q", "db_q"),
                            got, want):
        assert k.shape == ref.shape and k.dtype == ref.dtype, name
        assert _rel_err(k, ref) <= GRAD_TOL[dtype], (name, _rel_err(k, ref))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_gru_bwd_is_deterministic(dev, dtype):
    """No float atomics and partials sized from the shape alone: two
    launches agree bit for bit in all six gradients, at more 16-point tiles
    than the main kernel has blocks and a ragged last tile."""
    g = torch.Generator().manual_seed(17)
    args = _gru_bwd_args(g, 4229, 64, dtype, dev)
    first = gru.fused_gru_bwd(*args, 4)
    second = gru.fused_gru_bwd(*args, 4)
    want = gru.fused_gru_bwd_plain(*args, 4)
    torch.cuda.synchronize()
    for name, a, b, ref in zip(("dh0", "dx", "dw_zr", "db_zr", "dw_q", "db_q"),
                               first, second, want):
        assert torch.equal(a, b), name
        assert _rel_err(a, ref) <= GRAD_TOL[dtype], (name, _rel_err(a, ref))


@pytest.mark.parametrize("xdim", [48, 64])
@pytest.mark.parametrize("m,iters", [(95, 4), (32 * 133 + 5, 4), (4229, 3), (33, 1)])
def test_fused_gru_bwd_f32_route(dev, m, xdim, iters):
    """The f32 route (its own main kernel, the dW kernel's f32 micro-tile):
    point counts that are not a multiple of its 32-point tile, more tiles
    than the constant wave of blocks, input widths of three and four
    16-wide steps; held to its plain version within the f32 gradient
    tolerance (inside phase 3's 1e-4) and bit for bit between two
    launches."""
    g = torch.Generator().manual_seed(m + xdim + iters)
    args = _gru_bwd_args(g, m, xdim, torch.float32, dev)
    first = gru.fused_gru_bwd(*args, iters)
    second = gru.fused_gru_bwd(*args, iters)
    want = gru.fused_gru_bwd_plain(*args, iters)
    torch.cuda.synchronize()
    for name, a, b, ref in zip(("dh0", "dx", "dw_zr", "db_zr", "dw_q", "db_q"),
                               first, second, want):
        assert torch.equal(a, b), name
        assert a.shape == ref.shape and torch.isfinite(a).all(), name
        assert _rel_err(a, ref) <= GRAD_TOL[torch.float32], (name, _rel_err(a, ref))


def test_fused_gru_autograd_launches(dev):
    g = torch.Generator().manual_seed(3)
    args = [(torch.randn(s, generator=g) * 0.1).to(dev).requires_grad_()
            for s in [(40, 128), (40, 64), (192, 256), (256,), (192, 128), (128,)]]
    before = (gru.fused_gru.launches, gru.fused_gru_bwd.launches)
    gru.FusedGRU.apply(*args, 2).square().sum().backward()
    assert (gru.fused_gru.launches, gru.fused_gru_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = gru.fused_gru_bwd_plain(*[a.detach() for a in args],
                                   2 * gru.fused_gru_plain(
                                       *[a.detach() for a in args], 2), 2)
    for a, w in zip(args, want):
        assert _rel_err(a.grad, w) <= GRAD_TOL[torch.float32]


CBG_SHAPES = [  # (B, H, W, C, O): ragged row segments, C != O, 8..256 lanes
    (1, 5, 70, 8, 64), (2, 9, 64, 64, 64), (2, 7, 33, 128, 64),
    (1, 6, 130, 64, 128), (2, 4, 16, 128, 128), (1, 3, 8, 8, 8),
    # the backward's row groups and slabs: rows not a multiple of a group,
    # a ragged 64-pixel segment, groups of several samples; C != O at 128;
    # channels that are not whole 16-byte vectors
    (2, 9, 130, 128, 128), (3, 5, 64, 64, 128), (2, 6, 20, 12, 20),
    # past 128 channels: the U-Net's 64² group (2B = 4 at 8x8), two chunks
    # of input and two slices of output channels, one of either, a ragged
    # last chunk, and widths that are not whole vectors
    (4, 8, 8, 256, 256), (2, 9, 70, 256, 256), (1, 5, 20, 256, 128),
    (1, 6, 40, 128, 256), (1, 3, 24, 200, 136), (1, 4, 20, 150, 170)]


def _cbg_inputs(g, shape, dtype, dev, head, zero=False):
    b, h, w, c, o = shape
    x = torch.zeros(b, h, w, c) if zero else torch.randn(b, h, w, c, generator=g)
    wm = torch.randn(3, 3, c, o, generator=g) * (9 * c) ** -0.5
    bias = torch.randn(o, generator=g) * 0.1
    scal = None
    if head:
        scal = torch.stack([torch.randn(c, generator=g) * 0.1,
                            torch.rand(c, generator=g) + 0.5,
                            1 + 0.1 * torch.randn(c, generator=g),
                            0.1 * torch.randn(c, generator=g),
                            torch.zeros(c), torch.zeros(c)]).to(dev)
    return (x.to(dev, dtype), wm.to(dev, dtype), bias.to(dev, dtype), scal)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("shape", CBG_SHAPES)
def test_cbg_block_fwd(dev, dtype, head, shape):
    from deflow_tpu_torch.ops import cbg

    g = torch.Generator().manual_seed(sum(shape) + head)
    x, wm, bias, scal = _cbg_inputs(g, shape, dtype, dev, head)
    s, ps = cbg.cbg_block_fwd(x, wm, bias, scal)
    s_ref, ps_ref = cbg.cbg_block_fwd_plain(x, wm, bias, scal)
    torch.cuda.synchronize()
    assert s.shape == s_ref.shape and s.dtype == dtype
    assert _rel_err(s, s_ref) <= (2 ** -7 if dtype == torch.bfloat16 else 1e-5)
    assert _rel_err(ps.sum(0), ps_ref.sum(0)) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("shape", CBG_SHAPES)
def test_cbg_block_bwd(dev, dtype, head, shape):
    from deflow_tpu_torch.ops import cbg

    g = torch.Generator().manual_seed(sum(shape) * 3 + head)
    b, h, w, c, o = shape
    sp, wm, _, scal_out = _cbg_inputs(g, shape, dtype, dev, head)
    si = torch.randn(b, h, w, o, generator=g).to(dev, dtype)
    dz = torch.randn(b, h, w, o, generator=g).to(dev, dtype)
    scal_in = torch.stack([torch.randn(o, generator=g) * 0.1,
                           torch.rand(o, generator=g) + 0.5,
                           1 + 0.1 * torch.randn(o, generator=g),
                           0.1 * torch.randn(o, generator=g),
                           0.1 * torch.randn(o, generator=g),
                           0.1 * torch.randn(o, generator=g)]).to(dev)
    got = cbg.cbg_block_bwd(dz, si, sp, wm, scal_in, scal_out)
    want = cbg.cbg_block_bwd_plain(dz, si, sp, wm, scal_in, scal_out)
    torch.cuda.synchronize()
    tol = GRAD_TOL[dtype]
    assert got[0].shape == (b, h, w, c) and got[0].dtype == dtype
    assert _rel_err(got[0], want[0]) <= tol
    assert got[1].shape == (3, 3, c, o) and _rel_err(got[1], want[1]) <= tol
    assert _rel_err(got[2].sum(0), want[2].sum(0)) <= tol
    assert _rel_err(got[3].sum(0), want[3].sum(0)) <= tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 9, 130, 128, 128), (4, 32, 32, 64, 64),
                                   # one image row a sample: both halo rows
                                   # of every row group lie outside the image
                                   (2, 1, 70, 128, 128)])
def test_cbg_block_fwd_is_deterministic(dev, dtype, shape):
    """No float atomics: two launches agree bit for bit; one partial-sum
    row per row group of the kernel; and the plain version's result."""
    from deflow_tpu_torch.ops import _build, cbg

    g = torch.Generator().manual_seed(13)
    b, h, w, c, _ = shape
    x, wm, bias, scal = _cbg_inputs(g, shape, dtype, dev, True)
    first = cbg.cbg_block_fwd(x, wm, bias, scal)
    second = cbg.cbg_block_fwd(x, wm, bias, scal)
    s_ref, ps_ref = cbg.cbg_block_fwd_plain(x, wm, bias, scal)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    lib = _build.load("cbg", cbg._setup)
    assert first[1].shape[0] == lib.cbg_fwd_blocks(b, h, w, c, int(dtype == torch.bfloat16))
    assert _rel_err(first[0], s_ref) <= (2 ** -7 if dtype == torch.bfloat16 else 1e-5)
    assert _rel_err(first[1].sum(0), ps_ref.sum(0)) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 9, 130, 128, 128), (4, 32, 32, 64, 64)])
def test_cbg_block_bwd_is_deterministic(dev, dtype, shape):
    """No float atomics: two launches on the same inputs agree bit for bit."""
    from deflow_tpu_torch.ops import cbg

    g = torch.Generator().manual_seed(11)
    b, h, w, c, o = shape
    sp, wm, _, scal_out = _cbg_inputs(g, shape, dtype, dev, True)
    si = torch.randn(b, h, w, o, generator=g).to(dev, dtype)
    dz = torch.randn(b, h, w, o, generator=g).to(dev, dtype)
    scal_in = torch.stack([torch.randn(o, generator=g) * 0.1, torch.rand(o, generator=g) + 0.5,
                           torch.ones(o), torch.zeros(o), 0.1 * torch.randn(o, generator=g),
                           0.1 * torch.randn(o, generator=g)]).to(dev)
    first = cbg.cbg_block_bwd(dz, si, sp, wm, scal_in, scal_out)
    second = cbg.cbg_block_bwd(dz, si, sp, wm, scal_in, scal_out)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("shape", [  # (B, H, W, C, O)
    (2, 7, 100, 64, 64), (1, 5, 70, 128, 128), (2, 3, 90, 256, 256),
    (1, 6, 40, 64, 128), (1, 4, 20, 128, 64), (2, 5, 36, 48, 80)])
def test_cbg_block_fwd_f32_route(dev, head, shape):
    """The forward's f32 route (its 8 x 8 FFMA micro-tile, 4 rows a block at
    <= 64 input channels and 2 above, input channels in chunks of 32): rows
    not a multiple of its row group, map widths that are not a multiple of
    64, 64, 128 and 256 channels, C != O both ways, a ragged last chunk and
    widths that are not a multiple of 32; held to its
    plain version within the f32 tolerances of test_cbg_block_fwd (inside
    phase 3's 1e-4), one partial-sum row a row group, and bit for bit
    between two launches."""
    from deflow_tpu_torch.ops import _build, cbg

    g = torch.Generator().manual_seed(sum(shape) * 7 + head)
    b, h, w, c, _ = shape
    x, wm, bias, scal = _cbg_inputs(g, shape, torch.float32, dev, head)
    first = cbg.cbg_block_fwd(x, wm, bias, scal)
    second = cbg.cbg_block_fwd(x, wm, bias, scal)
    s_ref, ps_ref = cbg.cbg_block_fwd_plain(x, wm, bias, scal)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    lib = _build.load("cbg", cbg._setup)
    assert first[1].shape[0] == lib.cbg_fwd_blocks(b, h, w, c, 0)
    assert _rel_err(first[0], s_ref) <= 1e-5
    assert _rel_err(first[1].sum(0), ps_ref.sum(0)) <= GRAD_TOL[torch.float32]


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("shape", [  # (B, H, W, C, O)
    (2, 7, 100, 64, 64), (1, 5, 70, 128, 128), (2, 3, 90, 256, 256),
    (1, 6, 40, 64, 128), (1, 4, 20, 128, 64), (2, 5, 36, 48, 80),
    (1, 3, 20, 30, 18), (2, 9, 130, 200, 136)])
def test_cbg_block_bwd_f32_route(dev, head, shape):
    """The backward's f32 route (its dgrad's 8 x 8 FFMA micro-tile, 4 rows a
    block at <= 64 input channels and 2 above, output channels in chunks of
    32; its wgrad's 3 x 4 x 8 tile over units of 2 rows): rows not a
    multiple of either row group, map widths that are not a multiple of
    64, 64, 128 and 256 channels, C != O both ways, a ragged last o chunk,
    widths that are not a multiple of 32 or of 4 (element copies); dz_prev,
    dW, db and the statistics held to the plain version within the f32
    gradient tolerance (inside phase 3's 1e-4), one partial-sum row a row
    group, and bit for bit between two launches."""
    from deflow_tpu_torch.ops import _build, cbg

    g = torch.Generator().manual_seed(sum(shape) * 5 + head)
    b, h, w, c, o = shape
    sp, wm, _, scal_out = _cbg_inputs(g, shape, torch.float32, dev, head)
    si = torch.randn(b, h, w, o, generator=g).to(dev)
    dz = torch.randn(b, h, w, o, generator=g).to(dev)
    scal_in = torch.stack([torch.randn(o, generator=g) * 0.1, torch.rand(o, generator=g) + 0.5,
                           1 + 0.1 * torch.randn(o, generator=g),
                           0.1 * torch.randn(o, generator=g), 0.1 * torch.randn(o, generator=g),
                           0.1 * torch.randn(o, generator=g)]).to(dev)
    first = cbg.cbg_block_bwd(dz, si, sp, wm, scal_in, scal_out)
    second = cbg.cbg_block_bwd(dz, si, sp, wm, scal_in, scal_out)
    want = cbg.cbg_block_bwd_plain(dz, si, sp, wm, scal_in, scal_out)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    lib = _build.load("cbg", cbg._setup)
    assert first[2].shape[0] == first[3].shape[0] == lib.cbg_bwd_blocks(b, h, w, c, 0)
    tol = GRAD_TOL[torch.float32]
    assert first[0].shape == (b, h, w, c) and _rel_err(first[0], want[0]) <= tol
    assert first[1].shape == (3, 3, c, o) and _rel_err(first[1], want[1]) <= tol
    assert _rel_err(first[2].sum(0), want[2].sum(0)) <= tol
    assert _rel_err(first[3].sum(0), want[3].sum(0)) <= tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_cbg_all_zero_input(dev, dtype):
    from deflow_tpu_torch.ops import cbg

    g = torch.Generator().manual_seed(1)
    x, wm, bias, _ = _cbg_inputs(g, (2, 8, 40, 64, 64), dtype, dev, False, zero=True)
    s, ps = cbg.cbg_block_fwd(x, wm, bias)
    torch.cuda.synchronize()
    assert torch.equal(s, bias.expand_as(s))
    torch.testing.assert_close(ps.sum(0)[0], 640 * bias.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("b", [1, 2])
def test_cbg_chain_card_vs_cpu(dev, head, b):
    """The whole chain with its VJP in f32: card (kernels) vs CPU (plain)."""
    from deflow_tpu_torch.ops import cbg

    g = torch.Generator().manual_seed(b + 2 * head)
    x = torch.randn(b, 12, 20, 16, generator=g)
    params = [(torch.randn(3, 3, ci, co, generator=g) * (9 * ci) ** -0.5,
               torch.randn(co, generator=g) * 0.1,
               1 + 0.1 * torch.randn(co, generator=g),
               0.1 * torch.randn(co, generator=g))
              for ci, co in ((16, 32), (32, 32), (32, 24))]
    head_gb = ((1 + 0.1 * torch.randn(16, generator=g),
                0.1 * torch.randn(16, generator=g)) if head else ())
    tgt = torch.randn(b, 12, 20, 24, generator=g)
    leaves = {}
    for d in ("cpu", dev):
        leaf = lambda t: t.detach().to(d).clone().requires_grad_()
        xs = leaf(x)
        ps = [tuple(leaf(t) for t in p) for p in params]
        hs = tuple(leaf(t) for t in head_gb)
        y, means, _ = cbg.cbg_chain(xs, ps, hs)
        ((y - tgt.to(d)) ** 2).sum().backward()
        leaves[str(d)] = ([y, *means, xs.grad, *[t.grad for t in hs]]
                          + [t.grad for p in ps for t in (p[0], p[2], p[3])])
        # every block feeds a train-mode BN, so its conv bias has a zero
        # gradient in exact arithmetic: both sides hold rounding noise only
        scale = max(p[0].grad.abs().max().item() for p in ps)
        assert all(p[1].grad.abs().max().item() <= 1e-3 * scale for p in ps)
    for k, ref in zip(leaves[str(dev)], leaves["cpu"]):
        assert _rel_err(k.detach().cpu(), ref.detach()) <= 1e-4


@pytest.mark.parametrize("b", [2, 16])
def test_cbg_chain_256_card_vs_cpu(dev, b):
    """The 64² group's chain (the stem's BN + GELU deferred into one 256 ->
    256 block) with its VJP in f32 at siamese batch 2B = 2b: card (kernels)
    vs CPU (plain)."""
    from deflow_tpu_torch.ops import cbg

    g = torch.Generator().manual_seed(b)
    x = torch.randn(2 * b, 8, 8, 256, generator=g)
    params = [(torch.randn(3, 3, 256, 256, generator=g) * (9 * 256) ** -0.5,
               torch.randn(256, generator=g) * 0.1,
               1 + 0.1 * torch.randn(256, generator=g),
               0.1 * torch.randn(256, generator=g))]
    head_gb = (1 + 0.1 * torch.randn(256, generator=g), 0.1 * torch.randn(256, generator=g))
    tgt = torch.randn(2 * b, 8, 8, 256, generator=g)
    leaves = {}
    for d in ("cpu", dev):
        leaf = lambda t: t.detach().to(d).clone().requires_grad_()
        xs = leaf(x)
        ps = [tuple(leaf(t) for t in p) for p in params]
        hs = tuple(leaf(t) for t in head_gb)
        y, means, _ = cbg.cbg_chain(xs, ps, hs)
        ((y - tgt.to(d)) ** 2).sum().backward()
        leaves[str(d)] = ([y, *means, xs.grad, *[t.grad for t in hs]]
                          + [t.grad for p in ps for t in (p[0], p[2], p[3])])
    for k, ref in zip(leaves[str(dev)], leaves["cpu"]):
        assert _rel_err(k.detach().cpu(), ref.detach()) <= 1e-4


def test_scatter_gather_autograd_launches(dev):
    from deflow_tpu_torch.ops import voxel

    cfg = voxel.VoxelConfig((12.8, 12.8, 6.0))        # 8 x 8 grid, P = 64
    p = cfg.num_pillars
    ids = torch.tensor([[0, 0, 3, 9, 63, p, p], [1, 2, 2, 5, p, p, p]],
                       dtype=torch.int32)
    data = torch.randn(2, 7, 33).to(dev).requires_grad_()
    before = (scatter.sorted_segment_sum.launches, gather.sorted_rows_gather.launches)
    voxel.segment_sum_batched(data, ids.to(dev), p + voxel.TRASH_PAD).sum().backward()
    assert (scatter.sorted_segment_sum.launches,
            gather.sorted_rows_gather.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(data.grad[ids.to(dev) < p],
                       torch.ones_like(data.grad[ids.to(dev) < p]))
    assert (data.grad[ids.to(dev) >= p] == 0).all()

    valid = ids < p
    info = voxel.PillarInfo(ids.to(dev), valid.to(dev), None, None, None)
    table = torch.randn(2, p, 128).to(dev).requires_grad_()
    before = (scatter.sorted_segment_sum.launches, gather.sorted_rows_gather.launches)
    out = voxel.pseudoimage_gather_batched(table, info)
    out.sum().backward()
    assert (scatter.sorted_segment_sum.launches,
            gather.sorted_rows_gather.launches) == (before[0] + 1, before[1] + 1)
    counts = torch.zeros(2, p)
    for bi in range(2):
        for i in ids[bi][valid[bi]].tolist():
            counts[bi, i] += 1
    torch.testing.assert_close(table.grad.cpu(), counts[..., None].expand(2, p, 128))


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_gather_autograd_vs_cpu(dev, dtype):
    """The gradients of the embedder scatter and the decoder gather on a
    B = 2 plan whose trash tails put sentinel runs between the samples, as
    the train step builds them: card kernels vs the CPU's plain versions."""
    from deflow_tpu_torch.ops import voxel

    g = torch.Generator().manual_seed(5)
    cfg = voxel.VoxelConfig((3.2, 3.2, 6.0))          # 32 x 32 grid, P = 1024
    p, n = cfg.num_pillars, 3000
    ids = torch.full((2, n), p, dtype=torch.int32)
    for bi, nv in enumerate((2600, 2100)):
        ids[bi, :nv] = torch.randint(0, p, (nv,), generator=g).sort().values
    valid = ids < p
    data = torch.randn(2, n, 33, generator=g)
    table = torch.randn(2, p, 128, generator=g)
    w_seg = torch.randn(2, p + voxel.TRASH_PAD, 33, generator=g)
    w_out = torch.randn(2, n, 128, generator=g)
    grads = {}
    for d in (dev, torch.device("cpu")):
        x = data.to(d, dtype).requires_grad_()
        t = table.to(d, dtype).requires_grad_()
        seg = voxel.segment_sum_batched(x, ids.to(d), p + voxel.TRASH_PAD)
        info = voxel.PillarInfo(ids.to(d), valid.to(d), None, None, None)
        out = voxel.pseudoimage_gather_batched(t, info)
        ((seg.float() * w_seg.to(d)).sum() + (out.float() * w_out.to(d)).sum()).backward()
        grads[d.type] = (x.grad.cpu(), t.grad.cpu())
    # the scatter's backward is a gather: bit-exact; the gather's backward
    # is a segment-sum: f32 summation order, or one bf16 rounding
    assert torch.equal(grads["cuda"][0], grads["cpu"][0])
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-6)
    torch.testing.assert_close(grads["cuda"][1].float(), grads["cpu"][1].float(),
                               rtol=rtol, atol=atol)


# ------------------------------------------------- the SSL slice's kernels
@pytest.mark.parametrize("lanes", [1, 4, 7])
def test_segment_sum_lanes(dev, lanes):
    g = torch.Generator().manual_seed(lanes)
    s = 900
    ids = torch.cat([torch.randint(0, s - 100, (3000,), generator=g).sort().values,
                     torch.full((40,), s - 50), torch.tensor([s - 1]),     # long run, single row
                     torch.full((77,), s + 3)]).to(torch.int32).to(dev)     # sentinel tail
    rows = torch.randn(ids.shape[0], lanes, generator=g).to(dev)
    k = scatter.segment_sum_lanes(rows, ids, s)
    ref = scatter.segment_sum_lanes_plain(rows, ids, s)
    torch.cuda.synchronize()
    assert k.shape == (s, lanes) and k.dtype == torch.float32
    assert _rel_err(k, ref) <= 1e-6
    # row order: bit for bit the CPU's serial index_add_
    assert torch.equal(k.cpu(), scatter.segment_sum_lanes_plain(rows.cpu(), ids.cpu(), s))
    empty = torch.ones(s, dtype=torch.bool, device=dev)
    empty[ids[ids < s].long()] = False
    assert (k[empty] == 0).all()


@pytest.mark.parametrize("lanes", [1, 4, 7])
def test_segment_sum_lanes_long_run_and_gaps(dev, lanes):
    """A run of 1,000 rows from position 250 (across warp and CTA edges),
    runs of 32 across warp edges, gaps of 37 rows at the start, 100 at the
    end, 13 and 69 between (each zeroed by a warp) and of 2 (by a thread),
    no sentinel tail; integer rows, so the sums are exact in any order and
    held bit for bit."""
    g = torch.Generator().manual_seed(31 + lanes)
    s = 3000
    ids = torch.cat([torch.arange(37, 287), torch.full((1000,), 300),
                     torch.arange(301, 331).repeat_interleave(32),
                     torch.arange(400, 2900, 3)]).to(torch.int32).to(dev)
    rows = torch.randint(-3, 4, (ids.shape[0], lanes), generator=g).float().to(dev)
    k = scatter.segment_sum_lanes(rows, ids, s)
    torch.cuda.synchronize()
    assert torch.equal(k, scatter.segment_sum_lanes_plain(rows, ids, s))
    assert (k[:37] == 0).all() and (k[2900:] == 0).all() and (k[331:400] == 0).all()


def test_segment_sum_lanes_repeats_and_replays(dev):
    g = torch.Generator().manual_seed(37)
    s = 20000
    ids = torch.cat([torch.randint(0, s - 500, (30000,), generator=g).sort().values,
                     torch.full((2000,), 17000), torch.full((900,), s)]
                    ).sort().values.to(torch.int32).to(dev)
    # integer rows: a 2,000-row run of normals, summed in another order,
    # would differ from index_add_'s by more than 1e-6 of the largest sum
    rows = torch.randint(-3, 4, (ids.shape[0], 4), generator=g).float().to(dev)
    first = scatter.segment_sum_lanes(rows, ids, s)
    again = scatter.segment_sum_lanes(rows, ids, s)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first, scatter.segment_sum_lanes_plain(rows, ids, s))
    for (out,) in _graph_replays(lambda: scatter.segment_sum_lanes(rows, ids, s)):
        assert torch.equal(out, first)


def test_segment_sum_lanes_all_sentinel_and_empty(dev):
    rows = torch.ones(50, 4, device=dev)
    ids = torch.full((50,), 300, dtype=torch.int32, device=dev)
    assert (scatter.segment_sum_lanes(rows, ids, 200) == 0).all()
    none = scatter.segment_sum_lanes(rows[:0], ids[:0], 200)
    assert none.shape == (200, 4) and (none == 0).all()


def _ssl_clouds(g, sizes, spread=7.5):
    """[B, N, 3] clouds with per-sample valid counts (an empty sample
    allowed), half of the valid points flagged."""
    b, n = len(sizes), max(max(sizes), 1)
    pts = (torch.rand(b, n, 3, generator=g) * 2 - 1) * spread
    mask = torch.arange(n)[None, :] < torch.tensor(sizes)[:, None]
    pts = torch.where(mask[..., None], pts, 0.0)
    flag = mask & (torch.rand(b, n, generator=g) < 0.5)
    return pts, mask, flag


def _sweep_clouds(dev, spec, query, cand, hosted):
    """The sweep clouds of (points, mask, flag) triples on the card: the
    queries device-sorted, the candidates device-sorted or, with
    ``hosted``, from the host cell prep (each sample's masked tail in
    place)."""
    from deflow_tpu_torch.data.host_prep import chamfer_cell_prep
    from deflow_tpu_torch.ops import chamfer

    qc = chamfer._sweep_sort(*(t.to(dev) for t in query), spec)
    q, mq, fq = cand
    if hosted:
        cps = [chamfer_cell_prep(q[i].numpy(), mq[i].numpy(), fq[i].numpy(),
                                 lo=spec.lo, hi=spec.hi) for i in range(q.shape[0])]
        cc = chamfer._sweep_cloud_from_host(
            *(torch.from_numpy(np.stack([c[k] for c in cps])).to(dev)
              for k in ("lanes", "sid", "start")), spec)
    else:
        cc = chamfer._sweep_sort(q.to(dev), mq.to(dev), fq.to(dev), spec)
    return qc, cc


def _graph_replays(fn, times=2):
    """``fn``'s outputs from a CUDA graph that captured one call (after a
    warm-up call on a side stream), cloned after each of ``times`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    outs = []
    for _ in range(times):
        graph.replay()
        torch.cuda.synchronize()
        outs.append([o.clone() for o in (out if isinstance(out, tuple) else (out,))])
    return outs


SWEEP_CASES = {   # (query valid counts, candidate valid counts)
    "ragged": ([300, 1200], [700, 900]),
    "empty_sample": ([0, 400], [350, 0]),
    "single_point": ([1, 1], [1, 600]),
    "dense": ([3000, 2500], [2600, 3100]),      # clean and dirty chunks
}


@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("hosted", [False, True])
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_cell_sweep_matches_plain(dev, case, hosted, dual):
    """Bit-exact against the plain version: both round once per operation
    and share the tie rules.  Multi-sample clouds put dirty chunks at the
    sample boundaries and all-sentinel chunks at the tail."""
    from deflow_tpu_torch.ops import chamfer, sweep

    g = torch.Generator().manual_seed(len(case) + 2 * hosted + dual)
    spec = chamfer.NNSpec(method="grid", lo=(-8.0, -8.0), hi=(8.0, 8.0))
    qs, cs_ = SWEEP_CASES[case]
    p, mp, fp = _ssl_clouds(g, qs)
    q, mq, fq = _ssl_clouds(g, cs_)
    if case == "single_point":
        q[1, :550] = q[1, 0]                  # exact duplicates across blocks
    qc, cc = _sweep_clouds(dev, spec, (p, mp, fp), (q, mq, fq), hosted)
    for a, b in ((qc, cc), (cc, qc)):
        args = chamfer.sweep_inputs(a, b, spec)
        k = sweep.cell_sweep(*args, dual=dual)
        ref = sweep.cell_sweep_plain(*args, dual=dual)
        torch.cuda.synchronize()
        assert torch.equal(k, ref)
    if case == "dense":
        assert (args[4] == 0).any() and (args[4] == 1).any()


def _skewed_cloud(rng, n, valid):
    """Near-field-heavy radial density and two dense clusters, as AV2's near
    field (a copy of tools/sweep_check.py's ``skewed_cloud``)."""
    r = np.clip(rng.gamma(2.0, 8.0, n), 1.5, 51.0)
    th = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack([r * np.cos(th), r * np.sin(th),
                    rng.uniform(-2.8, 2.8, n)], -1).astype(np.float32)
    k = n // 16
    for c in ((8.0, 3.0), (-5.0, -12.0)):
        sel = rng.integers(0, n, k)
        pts[sel, :2] = np.asarray(c) + rng.normal(0, 0.6, (k, 2))
    mask = np.arange(n) < valid
    pts[~mask] = 0
    return pts, mask


def _sweep_both_ways(qc, cc, spec, dual):
    """Both directions' kernel and plain outputs and inputs."""
    from deflow_tpu_torch.ops import chamfer, sweep

    res = []
    for a, b in ((qc, cc), (cc, qc)):
        args = chamfer.sweep_inputs(a, b, spec)
        res.append((sweep.cell_sweep(*args, dual=dual),
                    sweep.cell_sweep_plain(*args, dual=dual), args))
    torch.cuda.synchronize()
    return res


@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("piece_blocks", [1, 2, 3])
def test_cell_sweep_many_pieces(dev, monkeypatch, piece_blocks, dual):
    """A hosted two-sample cloud whose first sample's masked tail spans
    more than 8 blocks: the query chunk that straddles the samples sweeps
    many pieces; bit-exact against the plain version."""
    from deflow_tpu_torch.ops import chamfer, sweep

    monkeypatch.setattr(sweep, "PIECE_BLOCKS", piece_blocks)
    g = torch.Generator().manual_seed(40 + piece_blocks)
    spec = chamfer.NNSpec(method="grid", lo=(-8.0, -8.0), hi=(8.0, 8.0))
    p, mp, fp = _ssl_clouds(g, [1500, 1500])
    q, mq, fq = _ssl_clouds(g, [1000, 1200])
    pad = lambda x, k: torch.cat([x, x.new_zeros((x.shape[0], k) + x.shape[2:])], 1)
    p, mp, fp = (pad(x, 1500) for x in (p, mp, fp))
    q, mq, fq = (pad(x, 4000) for x in (q, mq, fq))
    qc, cc = _sweep_clouds(dev, spec, (p, mp, fp), (q, mq, fq), hosted=True)
    res = _sweep_both_ways(qc, cc, spec, dual)
    assert int(res[0][2][3].sum(1).max()) > 3 * piece_blocks
    for k, ref, _ in res:
        assert torch.equal(k, ref)


@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("hosted", [False, True])
def test_cell_sweep_duplicates_across_pieces(dev, monkeypatch, hosted, dual):
    """1,200 exact copies of one point span three candidate blocks, each its
    own piece (the earlier piece must win); a few copies of another sit in
    one block (the larger orig row must win)."""
    from deflow_tpu_torch.ops import chamfer, sweep

    monkeypatch.setattr(sweep, "PIECE_BLOCKS", 1)
    g = torch.Generator().manual_seed(50 + 2 * hosted + dual)
    spec = chamfer.NNSpec(method="grid", lo=(-8.0, -8.0), hi=(8.0, 8.0))
    p, mp, fp = _ssl_clouds(g, [600, 500])
    q, mq, fq = _ssl_clouds(g, [2600, 900])
    q[0, 100:1300] = q[0, 100]
    q[0, 1400:1410] = q[0, 1450]
    fq[0, 100:1300] = torch.arange(1200) % 3 == 0
    fq[0, 1400:1410] = torch.arange(10) % 2 == 0
    p[0, :5], p[0, 5:10] = q[0, 100], q[0, 1450]
    qc, cc = _sweep_clouds(dev, spec, (p, mp, fp), (q, mq, fq), hosted)
    res = _sweep_both_ways(qc, cc, spec, dual)
    assert int(res[0][2][3].sum(1).max()) >= 3
    for k, ref, _ in res:
        assert torch.equal(k, ref)


@pytest.mark.parametrize("hosted", [False, True])
def test_cell_sweep_skewed(dev, hosted):
    """The skewed density of AV2's near field at 2 x 32,768 (dense clusters:
    chunks with twice the mean's blocks), on the loss's grid; bit-exact."""
    from deflow_tpu_torch.ops import chamfer

    rng = np.random.default_rng(60 + hosted)
    n = 32768
    spec = chamfer._resolve_spec("grid", n, n, 2.0, None)
    clouds = []
    for valid in ((28672, 26624), (27525, 29491)):
        pts, mask = zip(*(_skewed_cloud(rng, n, v) for v in valid))
        pts, mask = torch.from_numpy(np.stack(pts)), torch.from_numpy(np.stack(mask))
        clouds.append((pts, mask, mask & torch.from_numpy(rng.random(mask.shape) < 0.15)))
    qc, cc = _sweep_clouds(dev, spec, *clouds, hosted)
    res = _sweep_both_ways(qc, cc, spec, True)
    blocks = res[0][2][3].sum(1).float()
    assert blocks.max() >= 2 * blocks.mean()
    for k, ref, _ in res:
        assert torch.equal(k, ref)


def test_cell_sweep_repeats_and_replays(dev):
    """Two launches are bit-identical, and a CUDA graph of one call replays
    to the same output twice (the per-chunk counters start from zero)."""
    from deflow_tpu_torch.ops import chamfer, sweep

    g = torch.Generator().manual_seed(70)
    spec = chamfer.NNSpec(method="grid", lo=(-8.0, -8.0), hi=(8.0, 8.0))
    qc, cc = _sweep_clouds(dev, spec, _ssl_clouds(g, [3000, 2500]),
                           _ssl_clouds(g, [2600, 3100]), hosted=True)
    args = chamfer.sweep_inputs(qc, cc, spec)
    first = sweep.cell_sweep(*args)
    again = sweep.cell_sweep(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    before = sweep.cell_sweep.launches
    for (out,) in _graph_replays(lambda: sweep.cell_sweep(*args)):
        assert torch.equal(out, first)
    assert sweep.cell_sweep.launches == before + 2      # warm-up and capture


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (1, 33, 1000), (2, 1000, 1025),
                                   (3, 257, 2049), (1, 1025, 1023), (2, 5000, 3000),
                                   (1, 4097, 4096)])
def test_chamfer_min_matches_plain(dev, b, n, m):
    g = torch.Generator().manual_seed(b * n + m)
    p = (torch.rand(b, n, 3, generator=g) * 2 - 1) * 50
    q = (torch.rand(b, m, 3, generator=g) * 2 - 1) * 50
    mask = torch.rand(b, m, generator=g) < 0.8
    if m > 40:
        q[:, 30:40] = q[:, 10:20]             # exact duplicates: the lower row wins
        p[:, :min(n, 10)] = q[:, 10:10 + min(n, 10)]
        mask[:, 10:20] = mask[:, 30:40] = True
    if b > 1:
        mask[-1] = False                      # a sample with no valid q row
    p, q, mask = p.to(dev), q.to(dev), mask.to(dev)
    d, i = nn.chamfer_min(p, q, mask)
    rd, ri = nn.chamfer_min_plain(p, q, mask)
    torch.cuda.synchronize()
    assert torch.equal(d, rd) and torch.equal(i, ri)
    d1, i1 = nn.chamfer_min(p[0], q[0], mask[0])
    assert torch.equal(d1, d[0]) and torch.equal(i1, i[0])


def test_chamfer_min_no_candidates(dev):
    p = torch.randn(1, 5, 3, device=dev)
    d, i = nn.chamfer_min(p, p[:, :0], torch.zeros(1, 0, dtype=torch.bool, device=dev))
    assert (d == 3e38).all() and (i == 0).all()


def test_chamfer_min_duplicates_across_pieces(dev):
    """Exact duplicates 1,024 rows apart, in different q pieces: the lower
    index wins, bit-exact against the plain version."""
    g = torch.Generator().manual_seed(80)
    p = (torch.rand(2, 700, 3, generator=g) * 2 - 1) * 50
    q = (torch.rand(2, 2600, 3, generator=g) * 2 - 1) * 50
    q[:, 1034:1054] = q[:, 10:30]
    q[:, 2058:2078] = q[:, 10:30]
    p[:, :20] = q[:, 10:30]
    mask = torch.ones(2, 2600, dtype=torch.bool)
    p, q, mask = p.to(dev), q.to(dev), mask.to(dev)
    d, i = nn.chamfer_min(p, q, mask)
    rd, ri = nn.chamfer_min_plain(p, q, mask)
    torch.cuda.synchronize()
    assert torch.equal(d, rd) and torch.equal(i, ri)
    assert (i[:, :20] == torch.arange(10, 30, device=dev)).all()


def test_chamfer_min_negative_d_in_two_pieces(dev):
    """A p row at ±40 m whose expanded d is negative against a row of q
    piece 0 and more negative against a row of piece 1: the kernel merges
    the unclamped d and finds the later row, as the plain version does
    (clamping the pieces first would keep the earlier)."""
    rng = np.random.default_rng(5)
    p = torch.tensor([[[39.2, -38.4, 32.0]]])
    cand = (p[0] + torch.from_numpy(rng.normal(0, 1e-5, (4000, 3)))).float()
    d, _ = nn.chamfer_min_unclamped(p.expand(4000, 1, 3), cand[:, None],
                                    torch.ones(4000, 1, dtype=torch.bool))
    d = d[:, 0]
    neg = torch.nonzero(d < 0)[:, 0]
    a, b = neg[d[neg].argmax()], neg[d[neg].argmin()]
    assert d[b] < d[a] < 0
    q = torch.full((1, 2100, 3), 30.0)
    q[0, :, 0] += torch.arange(2100.0)
    q[0, 3], q[0, 1031] = cand[a], cand[b]
    mask = torch.ones(1, 2100, dtype=torch.bool)
    kd, ki = nn.chamfer_min(p.to(dev), q.to(dev), mask.to(dev))
    rd, ri = nn.chamfer_min_plain(p, q, mask)
    torch.cuda.synchronize()
    assert int(ri[0, 0]) == 1031 and float(rd[0, 0]) == 0.0
    assert torch.equal(kd.cpu(), rd) and torch.equal(ki.cpu(), ri)


def test_chamfer_min_repeats_and_replays(dev):
    """Two launches are bit-identical, and a CUDA graph of one call replays
    to the same output twice."""
    g = torch.Generator().manual_seed(90)
    p = ((torch.rand(2, 3000, 3, generator=g) * 2 - 1) * 50).to(dev)
    q = ((torch.rand(2, 2500, 3, generator=g) * 2 - 1) * 50).to(dev)
    mask = (torch.rand(2, 2500, generator=g) < 0.9).to(dev)
    first = nn.chamfer_min(p, q, mask)
    again = nn.chamfer_min(p, q, mask)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    for outs in _graph_replays(lambda: nn.chamfer_min(p, q, mask)):
        assert all(torch.equal(a, b) for a, b in zip(outs, first))


@pytest.mark.parametrize("hosted", [False, True])
def test_ssl_chamfer_card_vs_cpu(dev, hosted):
    """The fused SSL chamfer with its VJP wrt the warped cloud only: the
    card launches two sweeps and one lane segment-sum and matches the CPU's
    plain versions (distances exactly, gradients to f32 summation order)."""
    from deflow_tpu_torch.data.host_prep import chamfer_cell_prep
    from deflow_tpu_torch.ops import chamfer, sweep

    g = torch.Generator().manual_seed(7 + hosted)
    p, mp, fp = _ssl_clouds(g, [900, 1300], spread=40.0)
    q = (p + 0.5 * torch.randn(p.shape, generator=g)) * mp[..., None]
    mq, fq = mp.clone(), mp & (torch.rand(mp.shape, generator=g) < 0.3)
    host = None
    if hosted:
        cps = [chamfer_cell_prep(q[i].numpy(), mq[i].numpy(), fq[i].numpy())
               for i in range(2)]
        host = [torch.from_numpy(np.stack([c[k] for c in cps]))
                for k in ("lanes", "sid", "start")]
    res = {}
    for d in ("cpu", dev):
        leaf = p.to(d).clone().requires_grad_()
        before = (sweep.cell_sweep.launches, scatter.segment_sum_lanes.launches)
        out = chamfer.ssl_chamfer_distances(
            leaf, q.to(d), mp.to(d), mq.to(d), fp.to(d), fq.to(d),
            host_c1=None if host is None else [h.to(d) for h in host])
        sum(o.clamp(max=4.0).sum() for o in out).backward()
        res[str(d)] = [o.detach().cpu() for o in out] + [leaf.grad.cpu()]
        launched = (sweep.cell_sweep.launches - before[0],
                    scatter.segment_sum_lanes.launches - before[1])
        assert launched == ((0, 0) if d == "cpu" else (2, 1))
    for k, ref in zip(res[str(dev)][:4], res["cpu"][:4]):
        assert torch.equal(k, ref)
    assert _rel_err(res[str(dev)][4], res["cpu"][4]) <= 1e-6


# ------------------------- the device binning path and the MMHead's masking
def _device_plan(g, b, n, p, dev):
    """A device plan of pillar ids in the points' own order (20% trash),
    with a dense pillar of 150 points in the second sample."""
    from deflow_tpu_torch.ops import voxel

    ids = torch.randint(0, p, (b, n), generator=g)
    ids[torch.rand(b, n, generator=g) < 0.2] = p
    ids[1, torch.randperm(n, generator=g)[:150]] = 7
    ids = ids.to(torch.int32).to(dev)
    return ids, voxel.make_batched_scatter_plan(ids, p + voxel.TRASH_PAD)


@pytest.mark.parametrize("c,dtype", [(4, torch.bfloat16), (4, torch.float32),
                                     (33, torch.bfloat16), (33, torch.float32)])
def test_segment_sum_on_device_sorted_ids(dev, c, dtype):
    """The segment-sum on a device sort's ids (the centroids' 4 lanes, the
    features' 33): held as every plan is (the plan ascends within each
    sample, sentinels last; bit for bit against the serial sum)."""
    g = torch.Generator().manual_seed(c)
    b, n, p = 3, 1500, 1024
    _, plan = _device_plan(g, b, n, p, dev)
    feats = torch.randn(b * n, c, generator=g).to(dev, dtype)
    _held_segment_sum(feats.index_select(0, plan.order), plan.sorted_ids,
                      plan.num_rows, plan.samples)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [4, 33, 128])
def test_gather_on_unsorted_ids(dev, dtype, c):
    """The row gather at a device plan's flat ids in the points' own order
    (the planned scatter's backward, the centroids' gather back, the
    unsorted decoder gather): bit-exact, the trash's sentinel reading
    zeros."""
    g = torch.Generator().manual_seed(100 + c)
    b, n, p = 3, 1500, 1024
    _, plan = _device_plan(g, b, n, p, dev)
    table = torch.randn(plan.num_rows, c, generator=g).to(dev, dtype)
    assert not scatter.plan_is_sorted(plan.flat_ids, plan.num_rows, plan.samples)
    k = gather.sorted_rows_gather(table, plan.flat_ids, plan.num_rows)
    assert torch.equal(k, gather.gather_plain(table, plan.flat_ids, plan.num_rows))
    assert (k[plan.flat_ids >= plan.num_rows] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_planned_autograd_vs_cpu(dev, dtype):
    """The planned scatter and the planned gather, forward and backward,
    card kernels against the CPU's plain versions; one kernel launch each
    way."""
    from deflow_tpu_torch.ops import voxel

    g = torch.Generator().manual_seed(6)
    b, n, p = 2, 3000, 1024
    ids, _ = _device_plan(g, b, n, p, "cpu")
    valid = ids < p
    data = torch.randn(b, n, 33, generator=g)
    table = torch.randn(b, p, 128, generator=g)
    w_seg = torch.randn(b, p + voxel.TRASH_PAD, 33, generator=g)
    w_out = torch.randn(b, n, 128, generator=g)
    res = {}
    for d in (dev, torch.device("cpu")):
        plan = voxel.make_batched_scatter_plan(ids.to(d), p + voxel.TRASH_PAD)
        x = data.to(d, dtype).requires_grad_()
        t = table.to(d, dtype).requires_grad_()
        before = (scatter.sorted_segment_sum.launches, gather.sorted_rows_gather.launches)
        seg = voxel.segment_sum_planned(x, plan)
        info = voxel.PillarInfo(ids.to(d), valid.to(d), None, None, None)
        out = voxel.pseudoimage_gather_batched(t, info, plan)
        ((seg.float() * w_seg.to(d)).sum() + (out.float() * w_out.to(d)).sum()).backward()
        after = (scatter.sorted_segment_sum.launches, gather.sorted_rows_gather.launches)
        if d.type == "cuda":
            assert after == (before[0] + 2, before[1] + 2)
        res[d.type] = [v.detach().cpu() for v in (seg, out, x.grad, t.grad)]
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-6)
    for i in (0, 3):          # segment-sums: another order, or one bf16 rounding
        torch.testing.assert_close(res["cuda"][i].float(), res["cpu"][i].float(),
                                   rtol=rtol, atol=atol)
    for i in (1, 2):          # gathers: bit-exact
        assert torch.equal(res["cuda"][i], res["cpu"][i])


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_attention_finfo_min_on_the_card(dev, dtype):
    """The MMHead's masking on the card: a chunk whose keys are all masked
    gets uniform weights (the mean of its values), not NaN, and its
    gradients are finite; the rest against the CPU."""
    from deflow_tpu_torch.models.decoder import masked_attention

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(3, 4, 64, 32, generator=g) for _ in range(3))
    key_mask = torch.arange(64)[None, :] < torch.tensor([[64], [23], [0]])
    outs = {}
    for d in (dev, torch.device("cpu")):
        ins = [t.to(d, dtype).requires_grad_() for t in (q, k, v)]
        out = masked_attention(*ins, key_mask.to(d))
        out.float().square().sum().backward()
        outs[d.type] = [out.detach().float().cpu()] + [t.grad.float().cpu() for t in ins]
    for t in outs["cuda"]:
        assert torch.isfinite(t).all()
    uniform = v[2].to(dtype).float().mean(dim=1, keepdim=True).expand(4, 64, 32)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(outs["cuda"][0][2], uniform, rtol=tol, atol=tol)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert _rel_err(got, want) <= (2e-5 if dtype == torch.float32 else 2 ** -6)


STEM_SHAPES = [  # (N, H, W, C, O): the three stems' channel plans at small
    # maps, ragged tiles (map widths not a multiple of 32, heights not of
    # 16), maps narrower than a tile, 16 and 48 input channels, a batch of 5
    (1, 16, 16, 32, 64), (3, 34, 18, 32, 64), (2, 20, 36, 64, 128),
    (5, 18, 10, 128, 256), (1, 6, 4, 16, 64), (2, 2, 66, 48, 192),
    (1, 40, 70, 64, 64), (2, 8, 8, 128, 128)]


def _stem_inputs(g, shape, dev):
    n, h, w, c, o = shape
    x = torch.randn(n, h, w, c, generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn(o, c, 8, 8, generator=g) * (64 * c) ** -0.5).to(dev)
    bias = (0.1 * torch.randn(o, generator=g)).to(dev)
    dy = torch.randn(n, h // 2, w // 2, o, generator=g).to(dev, torch.bfloat16)
    return x, wt, bias, dy


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_conv(dev, shape):
    """The stem's forward, dgrad and wgrad kernels against their plain s2d
    versions (bf16 operands, f32 sums), 2^-6 of the largest element."""
    from deflow_tpu_torch.ops import stem

    g = torch.Generator().manual_seed(sum(shape))
    x, wt, bias, dy = _stem_inputs(g, shape, dev)
    n, h, w, c, o = shape
    y = stem.stem_fwd(x, wt, bias)
    dx = stem.stem_dgrad(dy, wt, h, w)
    dw, db = stem.stem_wgrad(x, dy)
    torch.cuda.synchronize()
    assert y.shape == (n, h // 2, w // 2, o) and y.dtype == torch.bfloat16
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert dw.shape == wt.shape and dw.dtype == torch.float32 and db.shape == (o,)
    tol = GRAD_TOL[torch.bfloat16]
    assert _rel_err(y, stem.stem_fwd_plain(x, wt, bias)) <= tol
    assert _rel_err(dx, stem.stem_dgrad_plain(dy, wt, h, w)) <= tol
    dw_ref, db_ref = stem.stem_wgrad_plain(x, dy)
    assert _rel_err(dw, dw_ref) <= tol
    assert _rel_err(db, db_ref) <= tol


@pytest.mark.parametrize("shape", [(3, 34, 18, 32, 64), (2, 20, 36, 64, 128)])
def test_stem_conv_is_deterministic(dev, shape):
    """No float atomics: two launches of each kernel agree bit for bit."""
    from deflow_tpu_torch.ops import stem

    g = torch.Generator().manual_seed(5)
    x, wt, bias, dy = _stem_inputs(g, shape, dev)
    h, w = shape[1:3]
    runs = [(stem.stem_fwd(x, wt, bias), stem.stem_dgrad(dy, wt, h, w), *stem.stem_wgrad(x, dy))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


def test_stem_conv_refuses_bad_inputs(dev):
    """The wrappers raise on odd maps, on non-contiguous NHWC input and on
    what the kernels do not take (f32 on the card, C % 16, O % 64): no
    fallback."""
    from deflow_tpu_torch.ops import stem

    g = torch.Generator().manual_seed(1)
    x, wt, bias, dy = _stem_inputs(g, (1, 16, 16, 32, 64), dev)
    with pytest.raises(ValueError, match="even"):
        stem.stem_fwd(x[:, :15].contiguous(), wt, bias)
    with pytest.raises(ValueError, match="even"):
        stem.stem_dgrad(dy, wt, 15, 16)
    with pytest.raises(ValueError, match="contiguous"):
        stem.stem_fwd(x.permute(0, 2, 1, 3), wt, bias)
    with pytest.raises(ValueError, match="contiguous"):
        stem.stem_wgrad(x, dy.transpose(1, 2))
    with pytest.raises(ValueError, match="bf16"):
        stem.stem_fwd(x.float(), wt, bias)
    with pytest.raises(ValueError, match="C % 16"):
        stem.stem_fwd(x[..., :24].contiguous(), wt[:, :24].contiguous(), bias)
    with pytest.raises(ValueError, match="O % 64"):
        stem.stem_fwd(x, wt[:48].contiguous(), bias[:48].contiguous())


def test_stem_conv_autograd_launches(dev):
    """``stem_conv`` under autograd: one forward, one dgrad and one wgrad
    launch, and the gradients of ``F.conv2d`` in f32 on the same bf16
    operands (2^-6 of the largest element)."""
    import torch.nn.functional as F

    from deflow_tpu_torch.ops import stem

    g = torch.Generator().manual_seed(2)
    x, wt, bias, dy = _stem_inputs(g, (2, 20, 36, 64, 128), dev)
    x32 = x.float().requires_grad_()
    w32 = wt.to(torch.bfloat16).float().requires_grad_()
    b32 = bias.clone().requires_grad_()
    ref = F.conv2d(x32.permute(0, 3, 1, 2), w32, b32, stride=2, padding=3)
    ref.permute(0, 2, 3, 1).backward(dy.float())
    xk, wk, bk = x.clone().requires_grad_(), wt.clone().requires_grad_(), bias.clone().requires_grad_()
    before = (stem.stem_fwd.launches, stem.stem_dgrad.launches, stem.stem_wgrad.launches)
    y = stem.stem_conv(xk, wk, bk)
    y.backward(dy)
    after = (stem.stem_fwd.launches, stem.stem_dgrad.launches, stem.stem_wgrad.launches)
    assert after == tuple(b + 1 for b in before)
    assert wk.grad.dtype == torch.float32 and bk.grad.dtype == torch.float32
    tol = GRAD_TOL[torch.bfloat16]
    assert _rel_err(y, ref.permute(0, 2, 3, 1)) <= tol
    for got, want in ((xk.grad, x32.grad), (wk.grad, w32.grad), (bk.grad, b32.grad)):
        assert _rel_err(got, want) <= tol
