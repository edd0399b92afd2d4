"""The SSL slice's kernels (plain versions) and chamfer ops against the JAX
package on the CPU in f32, its chamfer on the Pallas path in interpret mode
(``deflow_tpu.ops.chamfer._use_pallas`` patched on, ``_SCATTER_PALLAS_MIN``
= 1; the model is not involved).

Tolerances, each with its reason:
- lane segment-sum: sums of the same f32 values in another order (and a
  HIGHEST-precision one-hot product on the JAX side), 1e-6 relative + 1e-6;
- cell sweep: distances (dx² + dy²) + dz² within 1e-6 relative + 1e-6
  (XLA may contract a product-sum into an FMA), matched indices exactly
  equal (the duplicate-points case pins ties, which are exact);
- brute search: the expanded formula |p|² + |q|² − 2p·q cancels, and XLA
  rounds it at other places than one rounding per operation, so distances
  are held to 16·eps32·R², R² the largest squared norm of the sample
  (10·eps32·R² bounds the rounding of either evaluation); matched indices
  are equal, or both within that tolerance of the minimum;
- the chamfer sweep plumbing (slabs, windows): exactly equal;
- distances of the chamfer ops and seflow_loss: 1e-6 relative + 1e-5
  absolute; gradients within 1e-5 of their largest element (matched-pair
  sums of the same terms in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflow_tpu_torch.ops import chamfer as TC
from deflow_tpu_torch.ops.nn import chamfer_min, chamfer_min_plain, chamfer_min_unclamped
from deflow_tpu_torch.ops.scatter import segment_sum_lanes, segment_sum_lanes_plain
from deflow_tpu_torch.ops.sweep import cell_sweep, cell_sweep_plain
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

T2 = 4.0    # truncate 2 m, squared


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    import deflow_tpu.ops.chamfer as JC
    from deflow_tpu.ops import pallas_chamfer, pallas_scatter, pallas_sweep

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(JC, "_use_pallas", lambda: True)
    monkeypatch.setattr(JC, "_SCATTER_PALLAS_MIN", 1)
    jitted = (pallas_sweep.cell_sweep_pallas, pallas_scatter.segment_sum_lanes_pallas,
              pallas_chamfer._chamfer_min_single)
    for f in jitted:
        f.clear_cache()
    yield JC
    for f in jitted:
        f.clear_cache()


def _specs(**kw):
    """The same grid spec on both sides (16 m box, 2 m cells by default)."""
    from deflow_tpu.ops.chamfer import NNSpec

    kw = {"cell": 2.0, "ring": 1, "lo": (-8.0, -8.0), "hi": (8.0, 8.0), **kw}
    return NNSpec(method="grid", **kw), TC.NNSpec(method="grid", **kw)


def _clouds(seed, b=2, n=300, m=400, spread=7.5):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-spread, spread, (b, n, 3)).astype(np.float32)
    q = rng.uniform(-spread, spread, (b, m, 3)).astype(np.float32)
    p[..., 2] = rng.uniform(-1, 1, (b, n))
    q[..., 2] = rng.uniform(-1, 1, (b, m))
    mp, mq = rng.random((b, n)) > 0.15, rng.random((b, m)) > 0.15
    fp, fq = rng.random((b, n)) > 0.5, rng.random((b, m)) > 0.5
    p = np.where(mp[..., None], p, 0.0).astype(np.float32)
    q = np.where(mq[..., None], q, 0.0).astype(np.float32)
    return p, q, mp, mq, fp & mp, fq & mq


def _host_c1(q, mq, fq, cell=2.0, lo=(-8.0, -8.0), hi=(8.0, 8.0)):
    from deflow_tpu_torch.data.host_prep import chamfer_cell_prep

    cps = [chamfer_cell_prep(q[i], mq[i], fq[i], cell=cell, lo=lo, hi=hi)
           for i in range(q.shape[0])]
    return tuple(np.stack([c[k] for c in cps]) for k in ("lanes", "sid", "start"))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(got, want, rtol=1e-6, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


# ----------------------------------------------------------------- kernel 7
@pytest.mark.parametrize("lanes", [1, 4, 7])
def test_segment_sum_lanes_matches_pallas(interpret_pallas, lanes):
    from deflow_tpu.ops.pallas_scatter import segment_sum_lanes_pallas

    rng = np.random.default_rng(lanes)
    n, s = 1500, 700
    ids = np.sort(rng.integers(0, s, n - 90)).astype(np.int32)
    ids = np.concatenate([ids, np.full(90, s + 5, np.int32)])   # sentinel tail
    ids[200:260] = ids[200]                                      # one long run
    rows = rng.normal(0, 1, (n, lanes)).astype(np.float32)
    want = np.asarray(segment_sum_lanes_pallas(
        tuple(jnp.asarray(rows[:, k]) for k in range(lanes)), jnp.asarray(ids), s)).T
    r, i = _t(rows, ids)
    got = segment_sum_lanes_plain(r, i, s)
    assert got.shape == (s, lanes) and got.dtype == torch.float32
    _close(got, want)
    assert torch.equal(segment_sum_lanes(r, i, s), got)      # CPU: the plain version
    assert (got[np.setdiff1d(np.arange(s), ids)] == 0).all()


def test_lane_scatter_feeds_ascending_ids(monkeypatch):
    """The chamfer VJP's lane scatter sorts its ids before the lane
    segment-sum, which needs them ascending with the out-of-range ones
    last; its result is the plain scatter-add's."""
    from deflow_tpu_torch.ops import scatter

    seen = []
    orig = scatter.segment_sum_lanes

    def spy(rows, ids, segs):
        seen.append(scatter.plan_is_sorted(ids, segs))
        return orig(rows, ids, segs)

    monkeypatch.setattr(scatter, "segment_sum_lanes", spy)
    rng = np.random.default_rng(6)
    segs, n = 500, 3000
    flat_i = rng.integers(-20, segs + 20, n)
    w = rng.normal(0, 1, (n, 4)).astype(np.float32)
    got = TC._scatter_lanes_flat(torch.from_numpy(flat_i), torch.from_numpy(w), segs)
    want = np.zeros((segs + 1, 4))
    np.add.at(want, np.where((flat_i >= 0) & (flat_i < segs), flat_i, segs), w)
    assert seen == [True]
    _close(got, want[:segs])


# ----------------------------------------------------------------- kernel 8
def _jax_sweep_args(JC, monkeypatch, qc, cc, spec, dual):
    """The Pallas sweep's arguments as ``_sweep_call`` builds them, and its
    output."""
    from deflow_tpu.ops import pallas_sweep

    seen = {}
    orig = pallas_sweep.cell_sweep_pallas

    def spy(q_slab, c_slab, cs, cn, dirty=None, dual=True):
        seen["args"] = [np.asarray(a) for a in (q_slab, c_slab, cs, cn, dirty)]
        return orig(q_slab, c_slab, cs, cn, dirty, dual)

    monkeypatch.setattr(pallas_sweep, "cell_sweep_pallas", spy)
    out = np.asarray(JC._sweep_call(qc, cc, spec, dual))
    return seen["args"], out


def _both_clouds(JC, p, q, mp, mq, fp, fq, layout, jspec, tspec):
    """(JAX, port) query and candidate clouds; pc1 device- or host-sorted."""
    jq = JC._sweep_sort(jnp.asarray(p), jnp.asarray(mp), jnp.asarray(fp), jspec)
    tq = TC._sweep_sort(*_t(p, mp, fp), tspec)
    if layout == "hosted":
        hc = _host_c1(q, mq, fq)
        jc = JC._sweep_cloud_from_host(*map(jnp.asarray, hc), jspec)
        tc = TC._sweep_cloud_from_host(*_t(*hc), tspec)
    else:
        jc = JC._sweep_sort(jnp.asarray(q), jnp.asarray(mq), jnp.asarray(fq), jspec)
        tc = TC._sweep_sort(*_t(q, mq, fq), tspec)
    return jq, jc, tq, tc


def _check_sweep(got, want):
    for lane in (0, 2):
        _close(got[:, lane], want[:, lane], what=f"d lane {lane}")
        np.testing.assert_array_equal(got[:, lane + 1], want[:, lane + 1])
    assert (got[:, 4:] == 0).all()


@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("layout", ["sorted", "hosted"])
def test_cell_sweep_matches_pallas(interpret_pallas, monkeypatch, layout, dual):
    """The port's sweep plumbing builds the JAX package's slabs and windows,
    and the plain sweep on them gives the Pallas kernel's output, in both
    directions."""
    JC = interpret_pallas
    jspec, tspec = _specs()
    p, q, mp, mq, fp, fq = _clouds(3)
    jq, jc, tq, tc = _both_clouds(JC, p, q, mp, mq, fp, fq, layout, jspec, tspec)
    for (jqc, jcc), (tqc, tcc) in (((jq, jc), (tq, tc)), ((jc, jq), (tc, tq))):
        args, want = _jax_sweep_args(JC, monkeypatch, jqc, jcc, jspec, dual)
        mine = [a.numpy() for a in TC.sweep_inputs(tqc, tcc, tspec)]
        for name, a, b in zip(("q_slab", "c_slab", "cs", "cn"), mine, args):
            np.testing.assert_array_equal(a, b, err_msg=name)
        # dirty may differ only on chunks without a window (no work there)
        live = mine[3].sum(1) > 0
        np.testing.assert_array_equal(mine[4][live], args[4][live])
        got = cell_sweep_plain(*_t(*args[:2]), *_t(*args[2:]), dual=dual).numpy()
        _check_sweep(got, want)
        assert np.array_equal(cell_sweep(*_t(*args), dual=dual).numpy(), got)


@pytest.mark.parametrize("layout", ["sorted", "hosted"])
def test_cell_sweep_clean_chunks(interpret_pallas, monkeypatch, layout):
    """Clouds dense enough for clean chunks: the port marks some chunks
    clean, the w-free clean path is bit-identical to an all-dirty sweep on
    every real query row, and both match the Pallas kernel.

    Masked query rows (2e19 coordinates) may differ: on the hosted layout a
    clean chunk can hold pc0's masked tail beside real rows and fetch pc1's
    per-sample masked tail, whose 2e19 coordinates then sit at d = 0 without
    the w term.  The chamfer masks those rows' distances and zeroes their
    gradient payload, so nothing downstream reads them."""
    JC = interpret_pallas
    jspec, tspec = _specs()
    p, q, mp, mq, fp, fq = _clouds(3, n=1024, m=1536)
    jq, jc, tq, tc = _both_clouds(JC, p, q, mp, mq, fp, fq, layout, jspec, tspec)
    args = TC.sweep_inputs(tq, tc, tspec)
    dirty = args[4]
    assert (dirty == 0).any() and (dirty == 1).any(), "no clean chunk: vacuous"
    got = cell_sweep_plain(*args, dual=True)
    real = args[0][:, 3] < 1e19
    assert torch.equal(got[real], cell_sweep_plain(
        *args[:4], torch.ones_like(dirty), dual=True)[real])
    _, want = _jax_sweep_args(JC, monkeypatch, jq, jc, jspec, True)
    _check_sweep(got.numpy(), want)


def _piece_tables(cs, cn, ncc, piece_blocks):
    """Each chunk's valid block list (window 0 first, blocks ascending) cut
    at block boundaries into pieces of at most ``piece_blocks`` blocks: per
    piece index j, the windows (cs_j, cn_j) [nchunks, 3] of every chunk's
    j-th piece (no blocks where a chunk has fewer pieces)."""
    cs, cn = np.asarray(cs, np.int64), np.asarray(cn, np.int64)
    lo = np.clip(cs, 0, ncc)
    ln = np.clip(np.minimum(cs + cn, ncc) - lo, 0, None)
    first = np.cumsum(ln, 1) - ln                 # list position of each window
    tables = []
    for j in range(-(-int(ln.sum(1).max()) // piece_blocks)):
        a = np.clip(j * piece_blocks - first, 0, ln)
        b = np.clip((j + 1) * piece_blocks - first, 0, ln)
        tables.append(((lo + a).astype(np.int32), (b - a).astype(np.int32)))
    return tables


def _merge_pieces(outs, in_order=True):
    """Merge the pieces' sweep outputs: in piece order, a later piece wins
    only when strictly smaller; or in reverse order on (d, piece index),
    the lexicographic rule that makes the order of arrival irrelevant."""
    order = range(len(outs)) if in_order else range(len(outs) - 1, -1, -1)
    res, at = None, None
    for j in order:
        o = outs[j]
        if res is None:
            res, at = o.clone(), torch.full((o.shape[0], 2), j)
            continue
        for lane in (0, 1):
            d, cur = o[:, 2 * lane], res[:, 2 * lane]
            take = (d < cur) | ((d == cur) & (j < at[:, lane]))
            res[take, 2 * lane:2 * lane + 2] = o[take, 2 * lane:2 * lane + 2]
            at[take, lane] = j
    return res


@pytest.mark.parametrize("piece_blocks", [1, 2])
@pytest.mark.parametrize("layout", ["sorted", "hosted"])
def test_cell_sweep_pieces_merge_in_order(interpret_pallas, monkeypatch, layout,
                                          piece_blocks):
    """The exactness argument of the kernel's balanced design: the plain
    sweep over each chunk's window list cut into pieces at block boundaries
    (per-piece cs/cn), merged in piece order with a strict <, equals the
    uncut plain sweep and the Pallas kernel; so does the merge in reverse
    order on (d, piece index).  More than 512 copies of one point put
    exact duplicates in several blocks, so in several pieces."""
    JC = interpret_pallas
    jspec, tspec = _specs()
    p, q, mp, mq, fp, fq = _clouds(21, n=600, m=2600)
    q[0, 100:1300] = q[0, 100]                # 1,200 copies: three blocks
    q[0, 1400:1410] = q[0, 1450]              # a few copies in one block
    mq[0, 100:1300] = mq[0, 1400:1410] = mq[0, 1450] = True
    fq[0, 100:1300:3] = fq[0, 1400:1410:2] = True
    p[0, :5], p[0, 5:10] = q[0, 100], q[0, 1450]
    mp[0, :10] = True
    jq, jc, tq, tc = _both_clouds(JC, p, q, mp, mq, fp, fq, layout, jspec, tspec)
    for (jqc, jcc), (tqc, tcc) in (((jq, jc), (tq, tc)), ((jc, jq), (tc, tq))):
        for dual in (True, False):
            args = TC.sweep_inputs(tqc, tcc, tspec)
            whole = cell_sweep_plain(*args, dual=dual)
            tables = _piece_tables(args[2], args[3], args[1].shape[0], piece_blocks)
            outs = [cell_sweep_plain(args[0], args[1], *_t(cs_j, cn_j), args[4], dual=dual)
                    for cs_j, cn_j in tables]
            assert torch.equal(_merge_pieces(outs), whole)
            assert torch.equal(_merge_pieces(outs, in_order=False), whole)
            _, want = _jax_sweep_args(JC, monkeypatch, jqc, jcc, jspec, dual)
            _check_sweep(whole.numpy(), want)
    # the duplicates did land in several pieces of one chunk
    args = TC.sweep_inputs(tq, tc, tspec)
    assert (args[3].sum(1) > piece_blocks).any()
    assert len(_piece_tables(args[2], args[3], args[1].shape[0], piece_blocks)) > 1


# ----------------------------------------------------------------- kernel 9
def _expanded_atol(p, q, q_mask):
    """16·eps32·R² per sample, R² over p and the folded q ([..., 1])."""
    qf = np.where(q_mask[..., None], q, 1e6)
    r2 = np.maximum((p.astype(np.float64) ** 2).sum(-1).max(-1),
                    (qf.astype(np.float64) ** 2).sum(-1).max(-1))
    return 16 * np.finfo(np.float32).eps * np.asarray(r2)[..., None]


def _check_brute(p, q, q_mask, got_d, got_i, want_d, want_i):
    got_d, got_i = np.asarray(got_d, np.float64), np.asarray(got_i)
    tol = _expanded_atol(p, q, q_mask)
    assert (np.abs(got_d - np.asarray(want_d, np.float64)) <= tol).all()
    qf = np.where(q_mask[..., None], q, 1e6).astype(np.float64)
    at = lambda i: ((p - np.take_along_axis(qf, i[..., None].astype(np.int64), -2)) ** 2).sum(-1)
    same = got_i == np.asarray(want_i)
    assert (same | (np.abs(at(got_i) - at(np.asarray(want_i))) <= tol)).all()


@pytest.mark.parametrize("batched", [False, True])
def test_chamfer_min_matches_pallas(interpret_pallas, batched):
    from deflow_tpu.ops.pallas_chamfer import chamfer_min_pallas

    rng = np.random.default_rng(9)
    b, n, m = 2, 700, 900
    p = rng.uniform(-40, 40, (b, n, 3)).astype(np.float32)
    q = rng.uniform(-40, 40, (b, m, 3)).astype(np.float32)
    q[:, 500:520] = q[:, 100:120]            # exact duplicates: the lower row wins
    p[:, :20] = q[:, 100:120]                # queries sitting on them
    mq = rng.random((b, m)) > 0.2
    mq[:, 100:120] = mq[:, 500:520] = True
    mq[1] = False                             # no valid candidate at all
    if not batched:
        p, q, mq = p[0], q[0], mq[0]
    want_d, want_i = map(np.asarray, chamfer_min_pallas(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(mq)))
    tp, tq, tm = _t(p, q, mq)
    got_d, got_i = chamfer_min_plain(tp, tq, tm)
    assert got_d.dtype == torch.float32 and got_i.dtype == torch.int32
    _check_brute(p, q, mq, got_d, got_i, want_d, want_i)
    assert (got_i.numpy().reshape(-1, n)[0, :20] == np.arange(100, 120)).all()
    k_d, k_i = chamfer_min(tp, tq, tm)
    assert torch.equal(k_d, got_d) and torch.equal(k_i, got_i)


def _pieces_unclamped(p, q, q_mask, piece):
    """``chamfer_min_unclamped`` over q cut into pieces of ``piece`` rows,
    the pieces' unclamped d merged in q order with a strict < (ties to the
    lower piece)."""
    best = torch.full(p.shape[:2], 3.0e38)
    best_i = torch.zeros(p.shape[:2], dtype=torch.int64)
    for s0 in range(0, q.shape[1], piece):
        d, i = chamfer_min_unclamped(p, q[:, s0:s0 + piece], q_mask[:, s0:s0 + piece])
        take = d < best
        best, best_i = torch.where(take, d, best), torch.where(take, i + s0, best_i)
    return best, best_i


@pytest.mark.parametrize("piece", [128, 300, 1024])
def test_chamfer_min_pieces_merge_in_order(interpret_pallas, piece):
    """The exactness argument of the kernel's split over q: the pieces'
    unclamped (d, index) merged in q order by a strict < and clamped after
    equal the uncut plain search, and both the Pallas kernel; exact
    duplicates in different pieces go to the lower index."""
    from deflow_tpu.ops.pallas_chamfer import chamfer_min_pallas

    rng = np.random.default_rng(piece)
    b, n, m = 2, 300, 2100
    p = rng.uniform(-40, 40, (b, n, 3)).astype(np.float32)
    q = rng.uniform(-40, 40, (b, m, 3)).astype(np.float32)
    q[:, 1500:1520] = q[:, 100:120]          # duplicates in another piece
    p[:, :20] = q[:, 100:120]
    mq = rng.random((b, m)) > 0.2
    mq[:, 100:120] = mq[:, 1500:1520] = True
    tp, tq, tm = _t(p, q, mq)
    d, i = _pieces_unclamped(tp, tq, tm, piece)
    want_d, want_i = chamfer_min_plain(tp, tq, tm)
    assert torch.equal(d.clamp(min=0.0), want_d) and torch.equal(i.to(torch.int32), want_i)
    assert (want_i[:, :20] == torch.arange(100, 120)).all()
    jd, ji = map(np.asarray, chamfer_min_pallas(*map(jnp.asarray, (p, q, mq))))
    _check_brute(p, q, mq, want_d, want_i, jd, ji)


def _two_negative_candidates(seed):
    """One p row at ±40 m and two q rows near it whose expanded d are both
    negative (the formula cancels), the second strictly more negative.
    With |p|² just below 4096, |p|² + |q|² and 2p·q round on grids of
    different spacing, so d < 0 takes more than one value."""
    rng = np.random.default_rng(seed)
    p = np.array([[[39.2, -38.4, 32.0]]], np.float32)
    cand = (p[0] + rng.normal(0, 1e-5, (4000, 3))).astype(np.float32)
    d, _ = chamfer_min_unclamped(torch.from_numpy(np.repeat(p, 4000, 1)).reshape(4000, 1, 3),
                                 torch.from_numpy(cand)[:, None],
                                 torch.ones(4000, 1, dtype=torch.bool))
    d = d[:, 0].numpy()
    neg = np.flatnonzero(d < 0)
    a = neg[np.argmax(d[neg])]                # the least negative
    bb = neg[np.argmin(d[neg])]               # the most negative
    assert d[bb] < d[a] < 0
    return p, cand[a], cand[bb]


def test_chamfer_min_clamp_after_merge(interpret_pallas):
    """Two pieces both give d < 0 for one row, the later one more negative:
    merging the unclamped d finds the later row, as the uncut scan does;
    clamping the pieces first would tie them at 0 and keep the earlier."""
    from deflow_tpu.ops.pallas_chamfer import chamfer_min_pallas

    p, qa, qb = _two_negative_candidates(5)
    q = np.full((1, 2100, 3), 30.0, np.float32)
    q[0, :, 0] += np.arange(2100, dtype=np.float32)   # far rows
    q[0, 3], q[0, 1031] = qa, qb              # pieces 0 and 1 of 1024 rows
    mq = np.ones((1, 2100), bool)
    tp, tq, tm = _t(p, q, mq)
    want_d, want_i = chamfer_min_plain(tp, tq, tm)
    assert int(want_i[0, 0]) == 1031 and float(want_d[0, 0]) == 0.0
    d, i = _pieces_unclamped(tp, tq, tm, 1024)
    assert torch.equal(d.clamp(min=0.0), want_d) and torch.equal(i.to(torch.int32), want_i)
    # clamped first, both pieces give 0: the later is not strictly smaller,
    # so the merge would keep the earlier piece's row 3
    (d0, i0), (d1, _) = [chamfer_min_plain(tp, tq[:, s:s + 1024], tm[:, s:s + 1024])
                         for s in (0, 1024)]
    assert float(d0[0, 0]) == float(d1[0, 0]) == 0.0 and int(i0[0, 0]) == 3
    jd, ji = map(np.asarray, chamfer_min_pallas(*map(jnp.asarray, (p, q, mq))))
    _check_brute(p, q, mq, want_d, want_i, jd, ji)


# ------------------------------------------------------------ chamfer ops
def _grads_close(got, want):
    want = np.asarray(want)
    _close(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("layout", ["sorted", "hosted"])
def test_ssl_chamfer_distances_matches_jax(interpret_pallas, layout):
    """The four distance sets, the matched rows, and the gradient of their
    truncated sum wrt both clouds vs ``jax.grad``."""
    JC = interpret_pallas
    jspec, tspec = _specs()
    p, q, mp, mq, fp, fq = _clouds(11)
    hc = _host_c1(q, mq, fq) if layout == "hosted" else None
    fixed = [jnp.asarray(x) for x in (mp, mq, fp, fq)]

    def jloss(p0, p1):
        if hc is None:
            o = JC._ssl_nn(p0, p1, *fixed, jspec)
        else:
            o = JC._ssl_nn_hosted(p0, p1, *fixed, *map(jnp.asarray, hc), jspec)
        return sum(jnp.sum(jnp.minimum(d, T2)) for d in o[:4]), o

    (jv, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(p), jnp.asarray(q))
    tp, tq = (x.requires_grad_() for x in _t(p, q))
    to = TC._SSLNN.apply(tp, tq, *_t(mp, mq, fp, fq), tspec,
                         None if hc is None else tuple(_t(*hc)))
    sum(d.clamp(max=T2).sum() for d in to[:4]).backward()
    for k in range(4):
        _close(to[k].detach(), jo[k], atol=1e-5, what=f"d{k}")
    for k in range(4, 8):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
    _grads_close(tp.grad, jg[0])
    _grads_close(tq.grad, jg[1])
    d = TC.ssl_chamfer_distances(*_t(p, q, mp, mq, fp, fq), truncate=2.0,
                                 spec=tspec, host_c1=None if hc is None else _t(*hc))
    for k in range(4):
        assert torch.equal(d[k], to[k].detach())


@pytest.mark.parametrize("method", ["grid", "brute"])
def test_chamfer_distance_matches_jax(interpret_pallas, method):
    JC = interpret_pallas
    jspec, tspec = _specs()
    p, q, mp, mq, _, _ = _clouds(5)
    kw = ({"spec": jspec}, {"spec": tspec}) if method == "grid" else ({}, {})

    def jloss(p0, p1):
        o = JC.chamfer_distance(p0, p1, jnp.asarray(mp), jnp.asarray(mq),
                                return_idx=True, **kw[0])
        return jnp.sum(jnp.minimum(o[0], T2)) + jnp.sum(jnp.minimum(o[1], T2)), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(p), jnp.asarray(q))
    tp, tq = (x.requires_grad_() for x in _t(p, q))
    to = TC.chamfer_distance(tp, tq, *_t(mp, mq), return_idx=True, **kw[1])
    (to[0].clamp(max=T2).sum() + to[1].clamp(max=T2).sum()).backward()
    for k, (a, b, mb) in enumerate(((p, q, mq), (q, p, mp))):
        if method == "grid":
            _close(to[k].detach(), jo[k], atol=1e-5)
            np.testing.assert_array_equal(to[k + 2].numpy(), np.asarray(jo[k + 2]))
        else:
            _check_brute(a, b, mb, to[k].detach(), to[k + 2], jo[k], jo[k + 2])
    _grads_close(tp.grad, jg[0])
    _grads_close(tq.grad, jg[1])
    # unbatched inputs take the same path
    d0, d1 = TC.chamfer_distance(*_t(p[0], q[0], mp[0], mq[0]), **kw[1])
    assert torch.equal(d0, to[0][0].detach())
    tl = TC.truncated_chamfer_loss(*_t(p, q, mp, mq), method=method)
    jl = JC.truncated_chamfer_loss(*map(jnp.asarray, (p, q, mp, mq)), method=method)
    _close(float(tl), float(jl), rtol=1e-6, atol=0)


def test_duplicate_points_pin_tie_rules(interpret_pallas):
    """Exact duplicates, within one candidate block and across blocks (more
    than 512 copies of one point in one cell): the sweep keeps the largest
    row of the first block at the minimum, the brute search the lowest row;
    both as the JAX package does."""
    JC = interpret_pallas
    jspec, tspec = _specs()
    rng = np.random.default_rng(2)
    q = rng.uniform(-7.5, 7.5, (1, 1400, 3)).astype(np.float32)
    q[0, 100:800] = q[0, 100]                 # 700 copies: two candidate blocks
    q[0, 900:910] = q[0, 950]                 # a few copies in one block
    p = rng.uniform(-7.5, 7.5, (1, 300, 3)).astype(np.float32)
    p[0, :5] = q[0, 100]
    p[0, 5:10] = q[0, 950]
    m = lambda a: np.ones(a.shape[:2], bool)
    fp, fq = m(p), m(q)
    jo = JC._ssl_nn(*map(jnp.asarray, (p, q, m(p), m(q), fp, fq)), jspec)
    to = TC._SSLNN.apply(*_t(p, q, m(p), m(q), fp, fq), tspec, None)
    for k in range(4, 8):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
    assert (to[0][0, :10] == 0).all()
    jb = JC.chamfer_distance(*map(jnp.asarray, (p, q)), return_idx=True)
    tb = TC.chamfer_distance(*_t(p, q), return_idx=True)
    np.testing.assert_array_equal(tb[2].numpy(), np.asarray(jb[2]))
    assert (tb[2][0, :5] == 100).all() and (tb[2][0, 5:10] == 900).all()


# ------------------------------------------------------------- seflow_loss
@pytest.mark.parametrize("branch", ["grid", "grid_hosted", "brute"])
def test_seflow_loss_matches_jax(interpret_pallas, branch):
    from deflow_tpu.losses import seflow_loss as jax_seflow
    from deflow_tpu_torch.data.host_prep import chamfer_cell_prep
    from deflow_tpu_torch.losses import seflow_loss

    rng = np.random.default_rng(13)
    b, n = 2, 300
    pc0 = rng.uniform(-30, 30, (b, n, 3)).astype(np.float32)
    pc1 = (pc0 + rng.normal(0, 0.5, (b, n, 3))).astype(np.float32)
    flow = rng.normal(0, 0.3, (b, n, 3)).astype(np.float32)
    pose_flow = rng.normal(0, 0.1, (b, n, 3)).astype(np.float32)
    m0, m1 = rng.random((b, n)) > 0.1, rng.random((b, n)) > 0.1
    v0, v1 = rng.random((b, n)) > 0.05, rng.random((b, n)) > 0.05
    dufo0 = (rng.random((b, n)) < 0.3).astype(np.int32)
    dufo1 = (rng.random((b, n)) < 0.3).astype(np.int32)
    batch = {"pc0": pc0, "pc1": pc1, "pc0_mask": m0, "pc1_mask": m1,
             "dufo_label0": dufo0, "dufo_label1": dufo1}
    if branch == "grid_hosted":
        cps = [chamfer_cell_prep(pc1[i], m1[i], m1[i] & (dufo1[i] > 0))
               for i in range(b)]
        for k in ("lanes", "sid", "start"):
            batch[f"pc1_cell_{k}"] = np.stack([c[k] for c in cps])
    method = "brute" if branch == "brute" else "grid"
    out = {"pose_flow": pose_flow, "pc0_valid": v0, "pc1_valid": v1}

    jv, jg = jax.value_and_grad(lambda f: jax_seflow(
        {**{k: jnp.asarray(v) for k, v in out.items()}, "flow": f},
        {k: jnp.asarray(v) for k, v in batch.items()}, chamfer_method=method))(
            jnp.asarray(flow))
    tf = torch.from_numpy(flow).requires_grad_()
    tv = seflow_loss({**dict(zip(out, _t(*out.values()))), "flow": tf},
                     dict(zip(batch, _t(*batch.values()))), chamfer_method=method)
    tv.backward()
    _close(float(tv), float(jv), rtol=1e-6, atol=0)
    _grads_close(tf.grad, jg)


def test_seflow_loss_warns_on_mismatched_cell_prep():
    """A start table of another grid: one warning, then pc1 is sorted on
    the device and the value is the same."""
    from deflow_tpu_torch.losses import seflow_loss

    rng = np.random.default_rng(4)
    b, n = 1, 64
    pc = torch.from_numpy(rng.uniform(-5, 5, (b, n, 3)).astype(np.float32))
    ones = torch.ones(b, n, dtype=torch.bool)
    out = {"flow": torch.zeros(b, n, 3), "pose_flow": torch.zeros(b, n, 3),
           "pc0_valid": ones, "pc1_valid": ones}
    batch = {"pc0": pc, "pc1": pc + 0.1, "pc0_mask": ones, "pc1_mask": ones,
             "dufo_label0": torch.zeros(b, n, dtype=torch.int32),
             "dufo_label1": torch.ones(b, n, dtype=torch.int32)}
    base = seflow_loss(out, batch, chamfer_method="grid")
    bad = {**batch, "pc1_cell_lanes": torch.zeros(b, 5, n),
           "pc1_cell_sid": torch.zeros(b, n, dtype=torch.int32),
           "pc1_cell_start": torch.zeros(b, 32, dtype=torch.int32)}
    with pytest.warns(UserWarning, match="cell prep"):
        got = seflow_loss(out, bad, chamfer_method="grid")
    assert float(got) == float(base)
