"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one.  The file imports no
JAX, so on a machine without JAX it runs with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
All comparisons are bit-exact: the kernels and their plain versions do the
same integer arithmetic.
"""

import dataclasses

import numpy as np
import pytest
import torch

from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import bpr as B
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import convert as CV
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import digits as DG
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import ec as E
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import gather as G
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import hist as H
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import precompute as PK
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as S
from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import PARAMS, MsmConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_all()
    return torch.device("cuda")


def _field_words(rng, n):
    """[n, 8] u32 words of random values below p."""
    vals = [int.from_bytes(rng.bytes(32), "little") % PARAMS.p for _ in range(n)]
    return np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for v in vals],
                    dtype=np.uint32)


def _coords(rng, n, dev):
    return from_numpy_u32(np.stack([_field_words(rng, n), _field_words(rng, n)], axis=1), dev)


def _point_rows(rng, n, dev):
    """[n, TW] packed rows with coordinates < p (normalized limbs)."""
    limbs = rng.integers(0, 1 << 13, size=(n, 4, 20), dtype=np.uint32)
    limbs[:, :, 19] %= 0x25                                  # value < p
    packed = limbs[:, :, 0::2] | (limbs[:, :, 1::2] << 16)
    rows = np.zeros((n, E.TW), dtype=np.uint32)
    rows[:, :40] = packed.reshape(n, 40)
    return from_numpy_u32(rows, dev)


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a, b)


#: Point counts of the conversion tests: one point, a ragged warp, a ragged
#: block, a block and a point.
CONVERT_NS = [1, 31, 300, 4097]


@pytest.mark.parametrize("n", CONVERT_NS)
def test_convert(dev, n):
    coords = _coords(np.random.default_rng(1), n, dev)
    assert _same(CV.build_table_doubled(coords), CV.build_table_doubled_plain(coords))


@pytest.mark.parametrize("nb,case", [(2048, "mixed"), (70000, "mixed")] + [
    (nb, case) for nb in (4096, 32768)
    for case in ("one bucket", "sentinel", "sorted", "top bucket")])
def test_hist(dev, nb, case):
    """The shared-memory histogram against its plain version.  A mixed key
    set, also at more buckets than a block holds (three ranges of 23334);
    at the pipeline's bucket counts, key sets that stress it, with
    window counts that split the card's SMs unevenly (3: several clusters a
    window, atomics into zeroed counts; 17: one cluster a window, plain
    stores), an odd key count, and the keys both contiguous, as the
    pipeline holds them, and as the transpose of [n, Wg]."""
    rng = np.random.default_rng(2)
    if case == "mixed":
        keys = rng.integers(0, nb + 1, size=(3, 4096)).astype(np.int32)
        keys[0, :1000] = 7
        keys[1, :] = nb
        k = torch.from_numpy(keys).to(dev)
        assert _same(H.bucket_counts(k, nb), H.bucket_counts_plain(k, nb))
        return
    for wg in (3, 17):
        n = 100003
        if case == "one bucket":
            keys = np.full((wg, n), nb // 3)
        elif case == "sentinel":
            keys = np.full((wg, n), nb)
        elif case == "sorted":
            keys = np.sort(rng.integers(0, nb + 1, size=(wg, n)), axis=1)
        else:
            keys = np.full((wg, n), nb - 1)
        k = torch.from_numpy(keys.astype(np.int32)).to(dev)
        want = H.bucket_counts_plain(k, nb)
        assert _same(H.bucket_counts(k, nb), want), wg
        assert _same(H.bucket_counts(k.T.contiguous().T, nb), want), wg


#: (scalars, c) of the entries kernel's cases: the main path at 2^20 (c = 16,
#: W = 16) and at 2^16 (c = 13, W = 20, windows straddling two words).
ENTRIES_CASES = [(1 << 20, 16), (1 << 16, 13)]


@pytest.mark.parametrize("single", [False, True], ids=["doubled", "single"])
@pytest.mark.parametrize("n,c", ENTRIES_CASES)
def test_signed_window_entries(dev, n, c, single):
    """The one-pass entries kernel against its plain version, bit for bit:
    the doubled table's sign n and rows from 0, or the fixed base's sign bit
    30 and rows n a window from a table base; every window, then a slice.
    Random words (most scalars >= r: the final carry is dropped) and the
    carry chain's edges (all zeros, all ones, a window's half, all-ones
    limbs).  The outputs are contiguous [wg, n] rows, one launch a call."""
    cfg = MsmConfig(chunk_size=c)
    nw, half = cfg.num_windows, 1 << (c - 1)
    rng = np.random.default_rng(c)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    words[0], words[1], words[2], words[3] = 0, 0xFFFFFFFF, half, half - 1
    words[4:9] = 0
    words[4:9, [1, 3, 5, 7, 2]] = 0xFFFFFFFF
    scalars = from_numpy_u32(words, dev)
    sbit, base, stride = ((1 << 30), 12345, n) if single else (n, 0, 0)
    for w0, wg in ((0, nw), (2, nw // 2)):
        _build.reset_launch_counts()
        keys, idxs = DG.signed_window_entries(scalars, cfg, sbit, base, stride, w0, wg)
        assert _build.launches["digits"] == 1
        assert keys.shape == idxs.shape == (wg, n)
        assert keys.is_contiguous() and idxs.is_contiguous()
        want = DG.signed_window_entries_plain(scalars, cfg, sbit, base, stride, w0, wg)
        assert _same(keys, want[0]) and _same(idxs, want[1]), (w0, wg)


def test_signed_window_entries_refuses_what_it_cannot_index(dev):
    """Windows starting past the scalar's 256 bits, c above 30 and rows past
    31 bits are refused before a launch."""
    scalars = torch.zeros((64, 8), dtype=torch.int32, device=dev)
    _build.reset_launch_counts()
    for cfg, sbit in ((MsmConfig(chunk_size=8, scalar_bits=264), 64),
                      (MsmConfig(chunk_size=31), 64),
                      (MsmConfig(chunk_size=16), 1 << 31)):
        with pytest.raises(ValueError, match="signed_window_entries"):
            DG.signed_window_entries(scalars, cfg, sbit)
    assert not _build.launches["digits"]


def test_compute_msm_2p16_with_entries_kernel_matches_oracle(dev):
    """compute_msm at 2^16 (c = 13, W = 20) and compute_msm_precomputed over
    a 2^16 base (c = 16, W' = 16), each launching the entries kernel once,
    equal the oracle."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm, compute_msm_precomputed
    from webgpu_msm_twisted_edwards_tpu_torch import precompute_msm_base
    from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle

    n = 1 << 16
    pts, sc = _oracle_inputs(n, 16)
    coords = from_numpy_u32(pts.view(np.uint32).reshape(n, 2, 8), dev)
    scalars = from_numpy_u32(sc.view(np.uint32).reshape(n, 8), dev)
    want = oracle.msm_parallel(pts, sc, c=16)
    _build.reset_launch_counts()
    got = compute_msm(coords, scalars)
    assert _build.launches["digits"] == 1 and (got["x"], got["y"]) == want
    pre = precompute_msm_base(coords)
    _build.reset_launch_counts()
    got = compute_msm_precomputed(pre, scalars)
    assert _build.launches["digits"] == 1 and (got["x"], got["y"]) == want


#: (table rows, row width, fragments, how the rows are named) of the row
#: gather's cases.  A call with more entries (64 a fragment) than
#: PARTITION_ENTRIES_PER_ROW a table row takes the partition by tile and the
#: copy in its order, else the copy in entry order: "random" at 512 rows is
#: the first; widths 64, 128 and 256 (the extraction gathers' carry, stored
#: and pair rows) and 12 (a width of no specialized copy) on both; two
#: entries a row (the carry gather's share at 2^20 points), the most that
#: copies in entry order; every entry naming one row; more entries than one
#: partition block holds, not a multiple of it nor of a warp, over a table
#: that is not a whole number of tiles; a table of more than MAX_TILES tiles
#: of TILE_LOG2 rows; zero fragments.
GATHER_CASES = {
    "random": (512, 128, 256, "random"),
    "w64 partitioned": (3000, 64, 300, "random"),
    "w64 direct": (30000, 64, 300, "random"),
    "w64 two entries a row": (9600, 64, 300, "random"),
    "w256 partitioned": (1000, 256, 40, "random"),
    "w256 direct": (4000, 256, 40, "random"),
    "w12 partitioned": (700, 12, 50, "random"),
    "w12 direct": (7000, 12, 50, "random"),
    "one row": (512, 128, 256, "one row"),
    "one row direct": (1 << 15, 128, 256, "one row"),
    "blocks and tiles": (20000 + 5, 128, 2500 + 3, "random"),
    "wide table": ((G.MAX_TILES << G.TILE_LOG2) + 3, 4,
                   G.PARTITION_ENTRIES_PER_ROW * (G.MAX_TILES << G.TILE_LOG2) // 64 + 9, "random"),
    "zero fragments": (512, 128, 0, "random"),
}


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather(dev, case):
    nt, w, nf, kind = GATHER_CASES[case]
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.integers(-2**31, 2**31, size=(nt, w), dtype=np.int64)
                             .astype(np.int32)).to(dev)
    pidx = rng.integers(0, nt, size=(64, nf)) if kind == "random" else np.full((64, nf), nt // 3)
    pidx_t = torch.from_numpy(pidx.astype(np.int32)).to(dev)
    _build.reset_launch_counts()
    got = G.row_gather(table, pidx_t)
    assert _build.launches["gather"] == (2 if 64 * nf > G.PARTITION_ENTRIES_PER_ROW * nt else 1)
    assert _same(got, G.row_gather_plain(table, pidx_t))


@pytest.mark.parametrize("case", ["random", "one row", "blocks and tiles", "wide table"])
def test_gather_order(dev, case):
    """The partition: every entry once with its table row, tiles in
    non-decreasing order; the same pairs as its plain version, whose order
    within a tile may differ (the kernel's is that of its atomics)."""
    nt, _, nf, kind = GATHER_CASES[case]
    rng = np.random.default_rng(4)
    pidx = rng.integers(0, nt, size=(64, nf)) if kind == "random" else np.full((64, nf), nt // 3)
    pidx_t = torch.from_numpy(pidx.astype(np.int32)).to(dev)
    got = G.gather_order(pidx_t, nt).to(torch.int64)
    want = G.gather_order_plain(pidx_t, nt).to(torch.int64)
    assert (torch.diff(got[:, 1] >> G.tile_log2(nt)) >= 0).all()
    assert torch.equal(got[got[:, 0].argsort()], want[want[:, 0].argsort()])


def _near_p_coords(rng, n, dev):
    """[n, 2, 8] affine words of coordinates within 4 of p - 1."""
    words = [[(PARAMS.p - 1 - int(rng.integers(0, 4))) >> (32 * j) & 0xFFFFFFFF for j in range(8)]
             for _ in range(2 * n)]
    return from_numpy_u32(np.array(words, dtype=np.uint32).reshape(n, 2, 8), dev)


def _rm_scan_inputs(rng, case, signed, dev):
    """(rows, aux_t) of a row-major scan: rows gathered from a table of 64
    points (the doubled table, or the single one for the signed scan), aux_t
    the same bits of sorted keys, and for the signed scan the sign bits.
    The cases beside "random" stress the template's warp stores and 26-bit
    madd: 300 fragments (not a multiple of the 64-thread block, nor of a
    warp), the whole fragment one segment, every step its own segment, every
    entry negated, and points whose coordinates are near p - 1."""
    nf = 300 if case == "ragged nf" else 256
    coords = _near_p_coords(rng, 64, dev) if case == "near p" else _coords(rng, 64, dev)
    table = (CV.build_table_pair_plain(coords)[0] if signed
             else CV.build_table_doubled_plain(coords))
    pidx = torch.from_numpy(rng.integers(0, table.shape[0], size=nf * S.K)).to(dev)
    rows = table[pidx].reshape(nf, S.K, S.TWR)
    return rows, _scan_aux(rng, case, signed, nf, dev)


def _scan_aux(rng, case, signed, nf, dev):
    """aux_t [K, nf] of _rm_scan_inputs' case: same bits, and sign bits for
    the signed scan."""
    keys = np.sort(rng.integers(0, 9, size=(S.K, nf)), axis=0)
    if case == "one segment":
        keys[:] = 3
    elif case == "segments of one":
        keys = np.broadcast_to(np.arange(S.K)[:, None], (S.K, nf))
    aux = S.keys_to_sames(torch.from_numpy(keys.astype(np.int32)).to(dev))
    if signed:
        sign = np.ones((S.K, nf)) if case == "every sign" else rng.integers(0, 2, size=(S.K, nf))
        aux = aux | (torch.from_numpy(sign.astype(np.int32)).to(dev) << 1)
    return aux


SCAN_CASES = ["random", "ragged nf", "one segment", "segments of one", "near p"]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan(dev, case):
    rows, sames = _rm_scan_inputs(np.random.default_rng(4), case, False, dev)
    assert _same(S.msm_scan_rm_sames(rows, sames), S.msm_scan_rm_sames_plain(rows, sames))


def _carry_flags(rng, n, case):
    """[n] 0/1 flags a of the carry scan: random, or long runs of 1 (each
    carry passes through whole chunks) broken by a few zeros."""
    if case == "random":
        return rng.integers(0, 2, size=n).astype(np.int32)
    a = np.ones(n, dtype=np.int32)
    a[rng.integers(0, n, size=max(1, n // 1000))] = 0
    return a


@pytest.mark.parametrize("case", ["random", "long runs of a = 1"])
def test_ab_scan_level(dev, monkeypatch, case):
    """One level over 4096 fragments (64 chunks of 64), and the three levels
    of the carry scan over the 2^20 path's 2^18 fragments (4096, 64 and 1
    chunks): the kernel against its plain version, level by level."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_carry_flags(rng, 4096, case)).to(dev)
    b = _point_rows(rng, 4096, dev)
    assert _same(S.ab_scan_level(a, b, 64), S.ab_scan_level_plain(a, b, 64))
    n = 1 << 18
    a = torch.from_numpy(_carry_flags(rng, n, case)).to(dev)
    b = _point_rows(rng, n, dev)
    levels, level = [], S.ab_scan_level
    monkeypatch.setattr(S, "ab_scan_level",
                        lambda a, b, kab: levels.append((a, b, kab)) or level(a, b, kab))
    S.seg_carry_scan(a, b)
    assert [(x[0].shape[0], x[2]) for x in levels] == [(n, 64), (4096, 64), (64, 64)]
    for la, lb, kab in levels:
        assert _same(level(la, lb, kab), S.ab_scan_level_plain(la, lb, kab))


@pytest.mark.parametrize("mask", ["random", "all 0", "all 1", "1 in 64"])
@pytest.mark.parametrize("n", [1, 33, 1000, 1 << 18])
def test_masked_add(dev, n, mask):
    """Rows whose padding words are not zero (the output's are), one row, a
    ragged warp, and the 2^20 path's extraction size; masks that leave
    whole warps out and that set one row in two warps."""
    rng = np.random.default_rng(6)
    a, b = _point_rows(rng, n, dev), _point_rows(rng, n, dev)
    for rows in (a, b):
        rows[:, 40:] = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, E.TW - 40),
                                                     dtype=np.int64).astype(np.int32)).to(dev)
    m = {"random": rng.integers(0, 2, size=n), "all 0": np.zeros(n), "all 1": np.ones(n),
         "1 in 64": np.arange(n) % 64 == 5}[mask]
    m = torch.from_numpy(np.asarray(m).astype(np.int32)).to(dev)
    assert _same(E.masked_add_rows(a, b, m), E.masked_add_rows_plain(a, b, m))


@pytest.mark.parametrize("w,per_window", [(1, 2), (20, 64), (16, 512), (3, 1024), (2, 4096)])
def test_reduce_rows_per_window(dev, w, per_window):
    """The one-launch reduce against the plain loop of masked adds: one
    round in one warp; the 2^16 path's windows; the 2^20 path's (dynamic
    shared memory above 48 KB); the most rows a block holds (160 KB); and
    windows that first take two rounds of the masked add."""
    rows = _point_rows(np.random.default_rng(12), w * per_window, dev)
    _build.reset_launch_counts()
    got = B.reduce_rows_per_window(rows, per_window)
    assert _build.launches["reduce_rows"] == 1
    halvings = max(0, (per_window // B.REDUCE_MAX_ROWS).bit_length() - 1)
    assert _build.launches["masked_add"] == halvings
    assert _same(got, B.reduce_rows_per_window_plain(rows, per_window))


def test_seg_carry_scan_kernels_match_plain(dev):
    """The recursion over ab_scan_level and masked_add_rows, on the kernels
    and on the CPU's plain versions."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(0, 2, size=5000).astype(np.int32))
    b = _point_rows(rng, 5000, "cpu")
    got = S.seg_carry_scan(a.to(dev), b.to(dev)).cpu()
    assert _same(got, S.seg_carry_scan(a, b))


@pytest.mark.parametrize("rows,chunks_per_window", [
    (2 * 256, 4), (13 * B.CHUNK, 13), (1 << 15, 512), (1280 * B.CHUNK, 64), (1 << 19, 1024)])
def test_bpr_stages(dev, rows, chunks_per_window):
    """Both stages against their plain versions: two small windows; 13
    chunks, so the last warp of stage 1 (four chunks of eight lanes) and of
    stage 2 (eight chunks of four lanes) is ragged; the fixed base's 512
    chunks; the 2^16 path's 1280 chunks (20 windows of 4096 buckets, a
    factor of 12 bits); the 2^20 path's 8192 chunks (eight windows of 2^16
    buckets)."""
    rng = np.random.default_rng(8)
    buckets = _point_rows(rng, rows, dev)
    m, g = B.bpr_stage1(buckets)
    assert _same((m, g), B.bpr_stage1_plain(buckets))
    assert _same(B.bpr_stage2(m, g, chunks_per_window),
                 B.bpr_stage2_plain(m, g, chunks_per_window))


@pytest.mark.parametrize("w,cbits", [(20, 13), (16, 16), (32, 8), (3, 16), (64, 4), (1, 16)])
def test_horner(dev, w, cbits):
    """The 2^16 and 2^20 paths' windows; lanes padded with the identity
    ((3, 16): five of eight); the kernel's 64 lanes, 256 threads; one window,
    which doubles nothing."""
    sums = _point_rows(np.random.default_rng(9), w, dev)
    assert _same(B.horner_fold(sums, cbits), B.horner_fold_plain(sums, cbits))


def test_compute_msm_cuda_matches_cpu(dev):
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
    from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle

    n = 4096
    pts = oracle.gen_points(n, seed=5)
    rng = np.random.default_rng(5)
    sc = rng.integers(0, 1 << 62, size=(n, 4), dtype=np.uint64)
    sc[:, 3] &= (1 << 58) - 1
    coords = pts.view(np.uint32).reshape(n, 2, 8)
    scalars = sc.view(np.uint32).reshape(n, 8)
    got = compute_msm(coords, scalars, chunk_size=8)
    assert got == compute_msm(coords, scalars, chunk_size=8, device="cpu")
    assert (got["x"], got["y"]) == oracle.msm(pts, sc, c=16)


def _oracle_inputs(n: int, seed: int):
    from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle

    pts = oracle.gen_points(n, seed=seed)
    rng = np.random.default_rng(seed)
    sc = rng.integers(0, 1 << 62, size=(n, 4), dtype=np.uint64)
    sc[:, 3] &= (1 << 58) - 1
    return pts, sc


def test_small_path_cuda_matches_oracle(dev):
    """n = 511 takes the small-input path (c = 4) on the card: no kernel
    launches, the oracle's answer."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
    from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle

    n = 511
    pts, sc = _oracle_inputs(n, 7)
    _build.reset_launch_counts()
    got = compute_msm(pts.view(np.uint32).reshape(n, 2, 8), sc.view(np.uint32).reshape(n, 8))
    assert not any(_build.launches.values())
    assert (got["x"], got["y"]) == oracle.msm(pts, sc, c=16)


def test_compute_msm_batch_cuda_matches_one_shot(dev):
    """k = 3 at 2^16 on the card: one table conversion, each result equal to
    compute_msm on its vector."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm, compute_msm_batch

    n = 1 << 16
    pts, sc = _oracle_inputs(n, 8)
    coords = from_numpy_u32(pts.view(np.uint32).reshape(n, 2, 8), dev)
    words = [sc.view(np.uint32).reshape(n, 8),
             # Random words: most scalars are >= the subgroup order.
             np.random.default_rng(9).integers(0, 1 << 32, size=(n, 8),
                                               dtype=np.uint64).astype(np.uint32),
             np.zeros((n, 8), np.uint32)]
    vectors = [from_numpy_u32(w, dev) for w in words]
    _build.reset_launch_counts()
    got = compute_msm_batch(coords, vectors)
    assert _build.launches["convert"] == 1
    assert got == [compute_msm(coords, v) for v in vectors]


@pytest.mark.parametrize("shards,staged", [(2, True), (2, False), (3, True)])
def test_sharded_kernel_path_matches_compute_msm(dev, monkeypatch, shards, staged):
    """compute_msm_sharded over [cuda:0] * shards, 4096 points a shard (c = 13,
    the kernels pipeline), equals compute_msm on the same points; the
    cross-shard fold (the per-window reduce for two shards, masked adds for
    three) equals its plain version on the gathered rows."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm, compute_msm_sharded
    from webgpu_msm_twisted_edwards_tpu_torch.parallel import sharded

    n = shards * 4096
    pts, sc = _oracle_inputs(n, 12)
    coords = from_numpy_u32(pts.view(np.uint32).reshape(n, 2, 8), dev)
    scalars = from_numpy_u32(sc.view(np.uint32).reshape(n, 8), dev)
    seen, fold = [], sharded.fold_window_sums

    def spy(rows):
        seen.append(rows)
        return fold(rows)

    monkeypatch.setattr(sharded, "fold_window_sums", spy)
    got = compute_msm_sharded(coords, scalars, mesh=[dev] * shards, staged=staged)
    assert got == compute_msm(coords, scalars)
    (rows,) = seen
    if shards == 2:
        gw = torch.stack(rows, dim=1).reshape(-1, E.TW)
        assert _same(B.reduce_rows_per_window(gw, 2), B.reduce_rows_per_window_plain(gw, 2))
    else:
        ones = torch.ones((rows[0].shape[0],), dtype=torch.int32, device=rows[0].device)
        want = got_rows = rows[0]
        for r in rows[1:]:
            got_rows = E.masked_add_rows(got_rows, r, ones)
            want = E.masked_add_rows_plain(want, r, ones)
        assert _same(got_rows, want)


def test_validate_pipeline_cuda(dev):
    from webgpu_msm_twisted_edwards_tpu_torch import validate_pipeline
    from webgpu_msm_twisted_edwards_tpu_torch.utils.limbs import u32_words_to_ints

    n = 1024
    pts, sc = _oracle_inputs(n, 11)
    words = pts.view(np.uint32).reshape(n, 2, 8)
    points = list(zip(u32_words_to_ints(words[:, 0]), u32_words_to_ints(words[:, 1])))
    scalars = u32_words_to_ints(sc.view(np.uint32).reshape(n, 8))
    for c in (8, 4):
        assert set(validate_pipeline(points, scalars, chunk_size=c).values()) == {"ok"}


@pytest.mark.parametrize("n", CONVERT_NS)
def test_convert_pair(dev, n):
    coords = _coords(np.random.default_rng(10), n, dev)
    pair = CV.build_table_pair(coords)
    assert _same(pair, CV.build_table_pair_plain(coords))
    assert _same(CV.build_table(coords), pair[0])


@pytest.mark.parametrize("n,times,rounds", [(n, t, 1) for n in (1, 31, 33, 1000) for t in (1, 16)]
                         + [(1000, 16, 2)])
def test_double_rows(dev, n, times, rounds):
    """One row, ragged warps and several blocks; padding words that are not
    zero (the output's are); and the precompute's chain, the kernel's lazy
    rows fed back through it (ops/precompute.py::shifted_base_coords)."""
    rng = np.random.default_rng(11)
    rows = _point_rows(rng, n, dev)
    rows[:, 40:] = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, E.TW - 40),
                                                 dtype=np.int64).astype(np.int32)).to(dev)
    for _ in range(rounds):
        got = E.double_rows(rows, times)
        assert _same(got, E.double_rows_plain(rows, times))
        rows = got


#: csrc/precompute.cu's NORM_K rows a thread and NORM_T threads a block:
#: a batch of the kernel's inversion is the K rows i*T + t (i < K) of
#: thread t, T*K rows a block.
NORM_K, NORM_T = 16, 128
#: A row inside a batch (thread 7's middle row).
NORM_MID = (NORM_K // 2) * NORM_T + 7


def _normalize_rows_case(case, dev):
    """Rows for normalize_rows: the zero rows sit at a batch's ends, fill a
    batch or a block, and z = p (0 mod p, words not 0) sits inside a
    batch."""
    k, t = NORM_K, NORM_T
    rng = np.random.default_rng(12)
    if case.startswith("n="):
        return _point_rows(rng, int(case[2:]), dev)
    rows = _point_rows(rng, 2 * k * t + 77, dev)
    if case == "double_rows":
        return E.double_rows(rows, 16)                   # lazy z, below 1.21p
    if case == "zero at batch ends":
        for r in (0, (k - 1) * t, k * t + 5, k * t + 5 + (k - 1) * t, 2 * k * t - 1):
            rows[r] = 0
    elif case == "zero batch":
        rows[3:k * t:t] = 0
    elif case == "zero block":
        rows[k * t:2 * k * t] = 0
    elif case == "z = p":
        limbs = np.array([(PARAMS.p >> (13 * i)) & 0x1FFF for i in range(20)], dtype=np.int64)
        words = limbs[0::2] | (limbs[1::2] << 16)
        rows[NORM_MID, 30:40] = torch.from_numpy(words.astype(np.int32)).to(dev)
    return rows


NORMALIZE_CASES = ["n=1", "n=31", "n=300", "n=4097", "zero at batch ends", "zero batch",
                   "zero block", "z = p", "double_rows"]


@pytest.mark.parametrize("case", NORMALIZE_CASES)
def test_normalize_rows(dev, case):
    rows = _normalize_rows_case(case, dev)
    want = PK.normalize_rows_plain(rows)
    assert _same(PK.normalize_rows(rows), want)
    if case == "z = p":
        assert not want[NORM_MID].any()


@pytest.mark.parametrize("case", SCAN_CASES + ["every sign"])
def test_scan_signed(dev, case):
    rows, bits = _rm_scan_inputs(np.random.default_rng(13), case, True, dev)
    assert _same(S.msm_scan_rm_signed(rows, bits), S.msm_scan_rm_signed_plain(rows, bits))


def _table_scan_inputs(rng, case, signed, dev):
    """(table, pidx [nf, K], aux_t) of a scan that reads the table by index,
    in the cases of _rm_scan_inputs; the last fragment's rows all the
    table's last row."""
    nf = 300 if case == "ragged nf" else 256
    coords = _near_p_coords(rng, 64, dev) if case == "near p" else _coords(rng, 64, dev)
    table = (CV.build_table_pair_plain(coords)[0] if signed
             else CV.build_table_doubled_plain(coords))
    pidx = torch.from_numpy(rng.integers(0, table.shape[0], size=(nf, S.K)).astype(np.int32))
    pidx[-1] = table.shape[0] - 1
    return table, pidx.to(dev), _scan_aux(rng, case, signed, nf, dev)


@pytest.mark.parametrize("signed,case", [(False, c) for c in SCAN_CASES]
                         + [(True, c) for c in SCAN_CASES + ["every sign"]])
def test_scan_table(dev, signed, case):
    """The table scans against their plain versions, the indices as the
    pipeline passes them (the transposed view of [nf, K]) and contiguous;
    and against the row-major scan of the gathered rows."""
    table, pidx, aux = _table_scan_inputs(np.random.default_rng(24), case, signed, dev)
    scan, plain, rm = ((S.msm_scan_table_signed, S.msm_scan_table_signed_plain,
                        S.msm_scan_rm_signed) if signed else
                       (S.msm_scan_table_sames, S.msm_scan_table_sames_plain, S.msm_scan_rm_sames))
    want = plain(table, pidx.T, aux)
    assert _same(scan(table, pidx.T, aux), want)
    assert _same(scan(table, pidx.T.contiguous(), aux), want)
    assert _same(rm(table[pidx.to(torch.int64)], aux), want)


def test_fixed_base_block_clamps_rows_past_the_table(dev):
    """A block of 2^21 entries (the gather kernel's gate) over a table of
    4096 rows: entries past the table read its last row, so the buckets equal
    those over the table padded with copies of that row."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP

    rng = np.random.default_rng(14)
    table = CV.build_table(_coords(rng, 4096, dev))
    nblk, nb = 1 << 21, 128
    digits = torch.zeros((1, nblk), dtype=torch.int32)
    digits[0, :4096] = torch.from_numpy(rng.integers(-128, 128, size=4096).astype(np.int32))
    digits = digits.to(dev)
    got = MP.window_group_bucket_sums(table, digits, nb, table_base=0)
    padded = torch.cat([table, table[-1:].expand(nblk - 4096, -1)])
    assert _same(got, MP.window_group_bucket_sums(padded, digits, nb, table_base=0))


def test_fixed_base_block_scan_reads_rows_past_the_table(dev):
    """The block's table scan, on the indices of a block whose entries pass
    the table's end (clamped to its last row), against its plain version;
    the block launches no gather."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP

    rng = np.random.default_rng(25)
    table = CV.build_table(_coords(rng, 4096, dev))
    nblk, nb = 1 << 16, 128
    digits = torch.zeros((1, nblk), dtype=torch.int32)
    digits[0, :4096] = torch.from_numpy(rng.integers(-128, 128, size=4096).astype(np.int32))
    _build.captures = {}
    _build.reset_launch_counts()
    try:
        MP.window_group_bucket_sums(table, digits.to(dev), nb, table_base=1024)
        args = _build.captures["scan_table_signed"][1]
    finally:
        _build.captures = None
    assert _build.launches["scan_table_signed"] == 1 and not _build.launches["gather"]
    assert int(args[1].max()) == table.shape[0] - 1
    assert _same(S.msm_scan_table_signed(*args), S.msm_scan_table_signed_plain(*args))


def test_default_route_launches_no_gather(dev, monkeypatch):
    """The doubled table's default scans rows by index even with the gather
    gate open; the quarter store gathers on the gather kernel."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP

    rng = np.random.default_rng(26)
    n, nb = 4096, 256
    table = CV.build_table_doubled(_coords(rng, n, dev))
    digits = torch.from_numpy(rng.integers(-nb, nb + 1, size=(3, n)).astype(np.int32)).to(dev)
    monkeypatch.setattr(MP, "_DMA_GATHER_MIN_ROWS", 0)
    _build.reset_launch_counts()
    default = MP.window_group_bucket_sums(table, digits, nb)
    assert _build.launches["scan_fused"] == 1, _build.launches
    assert not _build.launches["gather"] and not _build.launches["scan"]
    monkeypatch.setattr(MP, "_SCAN_QSTORE", True)
    _build.reset_launch_counts()
    assert _same(MP.window_group_bucket_sums(table, digits, nb), default)
    assert _build.launches["gather"] == 1 and _build.launches["scan_q"] == 1


def test_compute_msm_precomputed_cuda_matches_cpu(dev):
    """The merged table built on the card equals the CPU's (n = 256); one
    MSM at n = 4096, c = 8 over the card's base equals the same MSM over that
    base on the CPU, and the oracle."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm_precomputed, precompute_msm_base
    from webgpu_msm_twisted_edwards_tpu_torch.ops import precompute as PRE
    from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle
    from webgpu_msm_twisted_edwards_tpu_torch.utils.params import MsmConfig

    cfg = MsmConfig(chunk_size=8, scalar_bits=253)
    small = from_numpy_u32(oracle.gen_points(256, seed=6).view(np.uint32).reshape(256, 2, 8))
    assert _same(PRE.precompute_fixed_base(small.to(dev), cfg).table.cpu(),
                 PRE.precompute_fixed_base(small, cfg).table)

    n = 4096
    pts = oracle.gen_points(n, seed=5)
    rng = np.random.default_rng(5)
    sc = rng.integers(0, 1 << 62, size=(n, 4), dtype=np.uint64)
    sc[:, 3] &= (1 << 58) - 1
    coords = pts.view(np.uint32).reshape(n, 2, 8)
    scalars = sc.view(np.uint32).reshape(n, 8)
    pre = precompute_msm_base(coords, chunk_size=8)
    assert pre.table.is_cuda and pre.cfg.num_windows == 32
    got = compute_msm_precomputed(pre, scalars)
    assert got == compute_msm_precomputed(dataclasses.replace(pre, table=pre.table.cpu()), scalars)
    assert (got["x"], got["y"]) == oracle.msm(pts, sc, c=16)


def _scan_inputs(seed, table, nf=256):
    """Row-major rows [nf, K, TWR] from `table`, sorted keys [K, nf] with
    runs, and a sign bit per entry."""
    rng = np.random.default_rng(seed)
    pidx = torch.from_numpy(rng.integers(0, table.shape[0], size=nf * S.K)).to(table.device)
    rows = table[pidx].reshape(nf, S.K, S.TWR)
    keys = torch.from_numpy(np.sort(rng.integers(0, 9, size=(S.K, nf)), axis=0)
                            .astype(np.int32)).to(table.device)
    sign = torch.from_numpy(rng.integers(0, 2, size=(S.K, nf)).astype(np.int32)).to(table.device)
    return rng, rows, keys, sign


def _pret(rows, lblk):
    nf = rows.shape[0]
    return rows.reshape(nf // lblk, lblk, S.K, S.TWR)[..., :64].permute(0, 2, 3, 1).contiguous()


def test_scan_keys(dev):
    table = CV.build_table_doubled_plain(_coords(np.random.default_rng(15), 64, dev))
    _, rows, keys, _ = _scan_inputs(15, table)
    assert _same(S.msm_scan(rows, keys), S.msm_scan_plain(rows, keys))


@pytest.mark.parametrize("lblk", [256, 32, 8])
def test_scan_pret_keys(dev, lblk):
    table = CV.build_table_doubled_plain(_coords(np.random.default_rng(16), 64, dev))
    _, rows, keys, _ = _scan_inputs(16, table)
    rows_t = _pret(rows, lblk)
    got = S.msm_scan_pret(rows_t, keys)
    assert _same(got, S.msm_scan_pret_plain(rows_t, keys))
    assert _same(got, S.msm_scan(rows, keys))


def test_scan_pret_sames(dev):
    table = CV.build_table_doubled_plain(_coords(np.random.default_rng(17), 64, dev))
    _, rows, keys, _ = _scan_inputs(17, table)
    rows_t, sames = _pret(rows, 128), S.keys_to_sames(keys)
    assert _same(S.msm_scan_sames(rows_t, sames), S.msm_scan_sames_plain(rows_t, sames))


def test_scan_pret_signed(dev):
    table = CV.build_table_pair_plain(_coords(np.random.default_rng(18), 64, dev))[0]
    _, rows, keys, sign = _scan_inputs(18, table)
    rows_t, bits = _pret(rows, 64), S.keys_to_sames(keys) | (sign << 1)
    assert _same(S.msm_scan_signed(rows_t, bits), S.msm_scan_signed_plain(rows_t, bits))


def test_scan_q(dev):
    table = CV.build_table_doubled_plain(_coords(np.random.default_rng(19), 64, dev))
    _, rows, keys, _ = _scan_inputs(19, table)
    sames = S.keys_to_sames(keys)
    got = S.msm_scan_rm_sames_q(rows, sames)
    assert _same(got, S.msm_scan_rm_sames_q_plain(rows, sames))
    assert _same(got, S.msm_scan_rm_sames(rows, sames)[:, 1::2])


def test_scan_fused(dev):
    rng = np.random.default_rng(20)
    table = CV.build_table_doubled_plain(_coords(rng, 300, dev))
    pidx_t = torch.from_numpy(rng.integers(0, 600, size=(S.K, 256)).astype(np.int32)).to(dev)
    keys = torch.from_numpy(np.sort(rng.integers(0, 9, size=(S.K, 256)), axis=0)
                            .astype(np.int32)).to(dev)
    got = S.msm_scan_fused(table, pidx_t, keys)
    assert _same(got, S.msm_scan_fused_plain(table, pidx_t, keys))
    assert _same(got, S.msm_scan(G.row_gather(table, pidx_t).reshape(256, S.K, S.TWR), keys))


@pytest.mark.parametrize("n", [1, 33, 1000])
def test_extract_reconstruct(dev, n):
    """Every one of the 32 bits values on some row (on the one row in turn),
    same-segment bits without their step bit among them (ignored)."""
    rng = np.random.default_rng(21)
    table = CV.build_table_doubled_plain(_coords(rng, 64, dev))
    base, carry = _point_rows(rng, n, dev), _point_rows(rng, n, dev)
    pair = table[torch.from_numpy(rng.integers(0, 128, size=2 * n)).to(dev)].reshape(n, 2 * S.TWR)
    values = rng.permutation(np.arange(n) % 32)
    for shift in range(32 if n < 32 else 1):
        bits = torch.from_numpy(((values + shift) % 32).astype(np.int32)).to(dev)
        assert _same(E.extract_reconstruct_rows(base, pair, bits, carry),
                     E.extract_reconstruct_rows_plain(base, pair, bits, carry))


#: Switch settings of the configurations of the bucket-sum stage, and the
#: kernels each must launch beyond the default's.
CONFIGS = {
    "pret": ({"_SCAN_LAYOUT": "pret"}, {"scan_pret"}),
    "pret_keys": ({"_SCAN_LAYOUT": "pret", "_SCAN_SAMES": False}, {"scan_pret_keys"}),
    "single_rm": ({"_SINGLE_TABLE": True}, {"scan_table_signed", "convert_pair"}),
    "single_pret": ({"_SINGLE_TABLE": True, "_SCAN_LAYOUT": "pret"},
                    {"scan_pret_signed", "convert_pair"}),
    "quarter_store": ({"_SCAN_QSTORE": True}, {"scan_q", "extract_reconstruct"}),
    "dma_extract": ({"_DMA_EXTRACT": True}, {"scan_fused", "gather"}),
    "sort_i64": ({"_SORT_I64": True}, {"scan_fused"}),
    "no_dma_gather": ({"_DMA_GATHER": False, "_DMA_GATHER_MIN_ROWS": 0, "_SCAN_QSTORE": True},
                      {"scan_q", "extract_reconstruct"}),
}


@pytest.fixture(scope="module")
def msm_2_14(dev):
    """2^14 points (c = 13) and the CPU's answer in the default
    configuration."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
    from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle

    n = 1 << 14
    pts = oracle.gen_points(n, seed=22)
    rng = np.random.default_rng(22)
    sc = rng.integers(0, 1 << 62, size=(n, 4), dtype=np.uint64)
    sc[:, 3] &= (1 << 58) - 1
    coords = pts.view(np.uint32).reshape(n, 2, 8)
    scalars = sc.view(np.uint32).reshape(n, 8)
    return coords, scalars, compute_msm(coords, scalars, device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_compute_msm_configuration_matches_cpu(msm_2_14, monkeypatch, name):
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
    from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP

    switches, kernels = CONFIGS[name]
    for attr, value in switches.items():
        monkeypatch.setattr(MP, attr, value)
    coords, scalars, want = msm_2_14
    _build.reset_launch_counts()
    assert compute_msm(coords, scalars) == want
    ran = {k for k, v in _build.launches.items() if v}
    assert kernels <= ran, ran
    scans = {"scan", "scan_signed", "scan_pret", "scan_pret_keys", "scan_pret_signed", "scan_q",
             "scan_fused", "scan_table", "scan_table_signed"}
    assert not (scans - kernels) & ran, ran
    if name == "no_dma_gather":
        assert "gather" not in ran


def test_fused_bucket_rows_match_default(dev, monkeypatch):
    """fused=True, the default (both the fused scan), and the quarter store,
    which scans rows that the gather kernel copied."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP

    rng = np.random.default_rng(23)
    n, nb = 4096, 256
    table = CV.build_table_doubled(_coords(rng, n, dev))
    digits = torch.from_numpy(rng.integers(-nb, nb + 1, size=(3, n)).astype(np.int32)).to(dev)
    digits[1, :2000] = 5                                     # a run over many fragments
    fused = MP.window_group_bucket_sums(table, digits, nb, fused=True)
    assert _same(fused, MP.window_group_bucket_sums(table, digits, nb))
    monkeypatch.setattr(MP, "_SCAN_QSTORE", True)
    monkeypatch.setattr(MP, "_DMA_GATHER_MIN_ROWS", 0)
    assert _same(fused, MP.window_group_bucket_sums(table, digits, nb))


# ---------------------------------------------------------------------------
# The kernels of the measurement probes (webgpu_msm_twisted_edwards_tpu_torch/
# experiments/), on random 13-bit rows as the probes feed them.


def _rand(rng, shape, high, dev):
    return torch.from_numpy(rng.integers(0, high, size=shape).astype(np.int32)).to(dev)


def _probe_scan_inputs(seed, dev, nf=300):
    """Rows [nf, K, TWR], sorted keys [K, nf] in runs, same bits, signs."""
    rng = np.random.default_rng(seed)
    rows = _rand(rng, (nf, S.K, S.TWR), 1 << 13, dev)
    keys = _rand(rng, (S.K, nf), 9, dev).sort(dim=0).values
    return rng, rows, keys, S.keys_to_sames(keys), _rand(rng, (S.K, nf), 2, dev)


#: Fragments of the probe scan tests: 300 leaves the last warp with 12 lanes
#: (20 recompute fragment nf - 1 and store nothing), 20 is one part warp.
PROBE_NF = [300, 20]


@pytest.mark.parametrize("nf", PROBE_NF)
@pytest.mark.parametrize("store", [1, 2])
def test_probe_scan_out(dev, store, nf):
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import scan_out_probe as OP

    _, rows, keys, _, sgn = _probe_scan_inputs(30, dev, nf)
    assert _same(OP.scan_out(rows, keys, sgn, store), OP.scan_out_plain(rows, keys, sgn, store))


@pytest.mark.parametrize("nf", PROBE_NF)
@pytest.mark.parametrize("name", ["control", "nosel", "nowrite", "hoistread", "floor"])
def test_probe_scan_floor_variants(dev, name, nf):
    """The control and each ablation on the outputs it writes (pair 31 of
    nowrite and floor)."""
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import scan_floor_probe as FP

    _, rows, _, sames, _ = _probe_scan_inputs(31, dev, nf)
    flags = FP.VARIANTS[name]
    _build.reset_launch_counts()
    got = FP.variant(rows, sames, *flags, control=name == "control")
    assert _build.launches[f"scan_{name}"] == 1
    assert _same(FP.defined(got, flags[1]), FP.defined(FP.variant_plain(rows, sames, *flags),
                                                       flags[1]))


@pytest.mark.parametrize("nf,lblk", [(512, 64), (300, 20), (40, 8)])
@pytest.mark.parametrize("fuse,pret", [(False, False), (True, False), (False, True)],
                         ids=["dual", "dualf", "pret_dual"])
def test_probe_scan_dual(dev, fuse, pret, nf, lblk):
    """Thread f scans fragments f and f + nf/2: at nf = 300 the last warp has
    22 such pairs, at 40 one part warp has 20."""
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import scan_tune_probe as TP

    _, rows, keys, _, _ = _probe_scan_inputs(32, dev, nf)
    if pret:
        rows = TP.pre_transpose(rows, lblk)
    got = TP.msm_scan_dual(rows, keys, fuse=fuse, pret=pret)
    assert _same(got, TP.msm_scan_dual_plain(rows, keys, fuse=fuse, pret=pret))


def test_probe_bulk_gather(dev):
    """The bulk-copy gather equals its plain version and the pipeline's
    gather kernel on the same indices."""
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import dma_gather_probe as DP

    rng = np.random.default_rng(33)
    table = _rand(rng, (5000, S.TWR), 1 << 31, dev)
    pidx_t = _rand(rng, (S.K, 700), 5000, dev)
    got = DP.dma_gather(table, pidx_t)
    assert _same(got, DP.dma_gather_plain(table, pidx_t))
    assert _same(got, G.row_gather(table, pidx_t))


@pytest.mark.parametrize("nf", PROBE_NF)
def test_probe_scan_dma(dev, nf):
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import dma_gather_probe as DP

    rng, _, _, sames, _ = _probe_scan_inputs(34, dev, nf)
    table = _rand(rng, (4096, S.TWR), 1 << 13, dev)
    pidx_t = _rand(rng, (S.K, nf), 4096, dev)
    got = DP.msm_scan_dma(table, pidx_t, sames)
    assert _same(got, DP.msm_scan_dma_plain(table, pidx_t, sames))
    rows = G.row_gather(table, pidx_t).reshape(nf, S.K, S.TWR)
    assert _same(got, S.msm_scan_rm_sames(rows, sames))


@pytest.mark.parametrize("nf", [300, 37])
def test_probe_fused_gather(dev, nf):
    """Copy-only on the rows it writes, scan-only and fused on everything;
    300 and 37 fragments leave the last block of 32 partly empty (37: its
    quads past nf in all four warps)."""
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import fused_gather_probe as GP

    rng, _, keys, _, sgn = _probe_scan_inputs(35, dev, nf)
    table = _rand(rng, (2048, S.TWR), 1 << 13, dev)
    pidx_t = _rand(rng, (S.K, nf), 2048, dev)
    assert _same(GP.gather_copy(table, pidx_t)[:, 0], GP.gather_copy_plain(table, pidx_t)[:, 0])
    fused = GP.gather_fused(table, pidx_t, keys, sgn)
    assert _same(fused, GP.gather_fused_plain(table, pidx_t, keys, sgn))
    assert _same(GP.gather_scan(GP.stage_rows(table, pidx_t), keys, sgn), fused)


@pytest.mark.parametrize("n,nbins,tblk", [(1 << 16, 64, 4096), (10000, 4, 512), (3000, 7, 32)])
def test_probe_partition(dev, n, nbins, tblk):
    """The written rows (full tiles within cap) equal the stable sort's; a
    last block of fewer than tblk rows, bins that are not a power of two,
    rows whose bin is out of range."""
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import partition_probe as PP

    rng = np.random.default_rng(36)
    rows = _rand(rng, (n, 128), 1 << 31, dev)
    bins = _rand(rng, (n,), nbins, dev)
    bins[::97] = nbins          # out of range: such a row goes nowhere
    bins[5::101] = -1
    mask = PP.written(bins, nbins)
    assert mask.any()
    assert _same(PP.partition(rows, bins, nbins, tblk)[mask], PP.partition_plain(rows, bins,
                                                                               nbins)[mask])
