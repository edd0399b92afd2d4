"""The CUDA kernels against their plain PyTorch versions on the card, at
small and ragged shapes (the main-path shapes are in ``chip_smoke.py``).

Needs an NVIDIA card; skipped without one.  The tests directory's
conftest imports JAX, which the card's machine does not have, so run:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances are chip_smoke's: the gather is bit-exact; the f32 segment-sum
1e-5; bf16 one rounding of an f32 sum (rtol 2^-7); the GRU f32 1e-4 and
bf16 rtol 2^-6 / atol 4e-3.
"""

import pytest
import torch

from deflow_tpu_torch.ops import gather, gru, scatter

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [1, 5, 33, 64])
def test_segment_sum(dev, dtype, c):
    g = torch.Generator().manual_seed(c)
    seg = 300 + 8                     # not a multiple of the 128-row tile
    ids = _plan(g, [(700, 650), (500, 0), (900, 900), (300, 120)], seg, dev)
    # one long run: all 120 valid points of the last sample in one pillar
    ids[-300:-180] = 3 * seg + 17
    s = 4 * seg
    feats = torch.randn(ids.shape[0], c, generator=g).to(dev, dtype)
    k = scatter.sorted_segment_sum(feats, ids, s)
    ref = scatter.segment_sum_plain(feats, ids, s)
    torch.cuda.synchronize()
    assert k.shape == (s, c) and k.dtype == dtype
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-6)
    torch.testing.assert_close(k.float(), ref.float(), rtol=rtol, atol=atol)
    empty = torch.ones(s, dtype=torch.bool, device=dev)
    empty[ids[ids < s].long()] = False
    assert (k[empty] == 0).all()


def test_segment_sum_all_sentinel_and_empty(dev):
    feats = torch.ones(50, 3, device=dev)
    ids = torch.full((50,), scatter.sentinel_for(200), dtype=torch.int32,
                     device=dev)
    assert (scatter.sorted_segment_sum(feats, ids, 200) == 0).all()
    none = scatter.sorted_segment_sum(feats[:0], ids[:0], 200)
    assert none.shape == (200, 3) and (none == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [1, 3, 33, 128])
def test_gather_is_bit_exact(dev, dtype, c):
    g = torch.Generator().manual_seed(c)
    rows = 1000
    table = torch.randn(rows, c, generator=g).to(dev, dtype)
    ids = torch.cat([torch.randint(0, rows, (700,), generator=g).sort().values,
                     torch.full((13,), 2 ** 30), torch.tensor([-1, rows, 0]),
                     torch.randint(0, rows, (300,), generator=g)]
                    ).to(torch.int32).to(dev)
    k = gather.sorted_rows_gather(table, ids, rows)
    assert torch.equal(k, gather.gather_plain(table, ids, rows))
    short = gather.sorted_rows_gather(table, ids, rows // 2)
    assert torch.equal(short, gather.gather_plain(table, ids, rows // 2))


@pytest.mark.parametrize("dtype,xdim", [(torch.float32, 3),
                                        (torch.float32, 64),
                                        (torch.float32, 100),
                                        (torch.bfloat16, 16),
                                        (torch.bfloat16, 64)])
@pytest.mark.parametrize("m", [1, 31, 33, 1000])
@pytest.mark.parametrize("iters", [0, 1, 4])
def test_fused_gru(dev, dtype, xdim, m, iters):
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
    ref = gru.fused_gru_plain(*args, iters)
    torch.cuda.synchronize()
    assert k.shape == (m, 128) and k.dtype == dtype
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -6, 4e-3)
    torch.testing.assert_close(k.float(), ref.float(), rtol=rtol, atol=atol)


def test_wrappers_count_launches(dev):
    feats = torch.ones(4, 2, device=dev)
    ids = torch.tensor([0, 0, 1, 5], dtype=torch.int32, device=dev)
    before = (scatter.sorted_segment_sum.launches,
              gather.sorted_rows_gather.launches)
    scatter.sorted_segment_sum(feats, ids, 3)
    gather.sorted_rows_gather(feats, ids, 4)
    assert (scatter.sorted_segment_sum.launches,
            gather.sorted_rows_gather.launches) == (before[0] + 1, before[1] + 1)
