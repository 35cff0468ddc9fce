"""Every scan configuration of the port's bucket-sum stage against the JAX
package on the CPU, bit for bit (tolerance 0: integer arithmetic).

- The plain versions of the seven kernels of those configurations (msm_scan,
  msm_scan_pret, msm_scan_sames, msm_scan_signed, msm_scan_rm_sames_q,
  msm_scan_fused, extract_reconstruct_rows) against the JAX kernels in
  interpret mode, at 16 fragments (limb-major blocks of 8 or 16) and 128
  extraction rows holding every one of the 32 bit patterns; and the two
  scans that read the table by index (msm_scan_table_sames,
  msm_scan_table_signed) against the JAX scans of the rows that the JAX
  pipeline gathers for them (msm_scan_rm_sames, msm_scan_rm_signed).
- window_group_bucket_sums in each configuration of the module's switches
  against one eager JAX run of the default configuration at n=128, c=8,
  seed 79 (bucket ends in every residue class mod 4, so the quarter store
  replays 0, 1 and 2 steps): bit for bit where the configuration keeps the
  representatives, equal as points where it changes them (the single
  table's in-kernel negation, the int64 sort's order within a bucket).
- compute_msm under the quarter store and the single table against a
  python-int reference.
"""

import jax.numpy as jnp
import numpy as np
import jax_kernel_cache
import pytest
import torch

from conftest import random_points_scalars
from test_torch_kernels import _coords, _point_rows
from test_torch_pipeline import _reference_msm
from webgpu_msm_twisted_edwards_tpu.ops import convert as JCV
from webgpu_msm_twisted_edwards_tpu.ops import msm_pipeline as JMP
from webgpu_msm_twisted_edwards_tpu.ops.pallas import ec as JE
from webgpu_msm_twisted_edwards_tpu.ops.pallas import scan as JS
from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
from webgpu_msm_twisted_edwards_tpu_torch.models.cuzk import packed_rows_to_extpoints
from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP
from webgpu_msm_twisted_edwards_tpu_torch.ops.convert import decompose_scalars_signed
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import convert as CV
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import ec as E
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as S
from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32, to_numpy_u32
from webgpu_msm_twisted_edwards_tpu_torch.utils.limbs import ints_to_u32_words
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import MsmConfig

NF = 16
CFG = MsmConfig(chunk_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions issue many small tensor ops; with several test
    workers sharing the cores, torch's intra-op threads would mostly wait on
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_kernels_compiled_once():
    """Repeated JAX kernel calls reuse one compile (tests/jax_kernel_cache.py)."""
    with jax_kernel_cache.cached():
        yield


def _eq(jax_out, port_out: torch.Tensor) -> None:
    np.testing.assert_array_equal(to_numpy_u32(port_out), np.asarray(jax_out))


@pytest.fixture(scope="module")
def tables():
    """Doubled [128, TWR] and single [64, TWR] tables of 64 real points, as
    uint32 (the port's build kernels, held to the JAX ones in
    test_torch_kernels.py and test_torch_precompute.py)."""
    coords = from_numpy_u32(_coords(64, 21))
    return to_numpy_u32(CV.build_table_doubled(coords)), to_numpy_u32(CV.build_table(coords))


def _step_words(seed: int):
    """Per-fragment sorted keys [K, NF] with runs, their same bits, and a
    random sign bit per entry."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 9, size=(S.K, NF)), axis=0).astype(np.int32)
    sames = to_numpy_u32(S.keys_to_sames(torch.from_numpy(keys))).view(np.int32)
    sign = rng.integers(0, 2, size=(S.K, NF)).astype(np.int32)
    return rng, keys, sames, sign


def _rm_rows(rng, table: np.ndarray) -> np.ndarray:
    return table[rng.integers(0, table.shape[0], size=NF * S.K)].reshape(NF, S.K, S.TWR)


def _pret(rows: np.ndarray, lblk: int) -> np.ndarray:
    """[NF, K, TWR] -> the limb-major [NF//lblk, K, 64, lblk] layout."""
    return np.ascontiguousarray(
        rows.reshape(NF // lblk, lblk, S.K, S.TWR)[..., :64].transpose(0, 2, 3, 1))


def test_msm_scan(tables):
    rng, keys, _, _ = _step_words(31)
    rows = _rm_rows(rng, tables[0])
    want = JS.msm_scan(jnp.asarray(rows), jnp.asarray(keys), interpret=True)
    _eq(want, S.msm_scan(from_numpy_u32(rows), torch.from_numpy(keys)))


def test_msm_scan_pret(tables):
    """lblk = 8: two limb-major blocks.  Also equal to the row-major scan."""
    rng, keys, _, _ = _step_words(32)
    rows = _rm_rows(rng, tables[0])
    rows_t = _pret(rows, 8)
    want = JS.msm_scan_pret(jnp.asarray(rows_t), jnp.asarray(keys), interpret=True)
    got = S.msm_scan_pret(from_numpy_u32(rows_t), torch.from_numpy(keys))
    _eq(want, got)
    assert torch.equal(got, S.msm_scan(from_numpy_u32(rows), torch.from_numpy(keys)))


def test_msm_scan_sames(tables):
    rng, _, sames, _ = _step_words(33)
    rows_t = _pret(_rm_rows(rng, tables[0]), 16)
    want = JS.msm_scan_sames(jnp.asarray(rows_t), jnp.asarray(sames), interpret=True)
    _eq(want, S.msm_scan_sames(from_numpy_u32(rows_t), torch.from_numpy(sames)))


def test_msm_scan_signed(tables):
    """Rows of the single table with the sign in bit 1 of the step word."""
    rng, _, sames, sign = _step_words(34)
    rows_t = _pret(_rm_rows(rng, tables[1]), 8)
    bits = sames | (sign << 1)
    want = JS.msm_scan_signed(jnp.asarray(rows_t), jnp.asarray(bits), interpret=True)
    _eq(want, S.msm_scan_signed(from_numpy_u32(rows_t), torch.from_numpy(bits)))


def test_msm_scan_rm_sames_q(tables):
    """Rows i of the quarter store are steps 4i+2, 4i+3 of the full scan."""
    rng, _, sames, _ = _step_words(35)
    rows = _rm_rows(rng, tables[0])
    want = JS.msm_scan_rm_sames_q(jnp.asarray(rows), jnp.asarray(sames), interpret=True)
    got = S.msm_scan_rm_sames_q(from_numpy_u32(rows), torch.from_numpy(sames))
    _eq(want, got)
    full = S.msm_scan_rm_sames(from_numpy_u32(rows), torch.from_numpy(sames))
    assert torch.equal(got, full[:, 1::2])


def test_msm_scan_fused(tables):
    rng, keys, _, _ = _step_words(36)
    table = tables[0]
    pidx_t = rng.integers(0, table.shape[0], size=(S.K, NF)).astype(np.int32)
    want = JS.msm_scan_fused(jnp.asarray(table), jnp.asarray(pidx_t), jnp.asarray(keys),
                             interpret=True)
    _eq(want, S.msm_scan_fused(from_numpy_u32(table), torch.from_numpy(pidx_t),
                               torch.from_numpy(keys)))


def _table_scan_inputs(seed: int, table: np.ndarray):
    """Random table rows pidx [NF, K] (entry order), the rows they gather
    [NF, K, TWR], and the step words of _step_words."""
    rng, keys, sames, sign = _step_words(seed)
    pidx = rng.integers(0, table.shape[0], size=(NF, S.K)).astype(np.int32)
    return pidx, table[pidx], sames, sign


def _both_layouts(pidx: np.ndarray):
    """pidx_t [K, NF] as a contiguous array and as the transposed view of
    the [NF, K] entry-order indices, which the pipeline passes."""
    view = torch.from_numpy(pidx).T
    assert not view.is_contiguous()
    return view.contiguous(), view


def test_msm_scan_table_sames(tables):
    """Rows of the doubled table read by index: the JAX package gathers them
    (dma_row_gather) and scans them with msm_scan_rm_sames."""
    pidx, rows, sames, _ = _table_scan_inputs(40, tables[0])
    want = JS.msm_scan_rm_sames(jnp.asarray(rows), jnp.asarray(sames), interpret=True)
    for pidx_t in _both_layouts(pidx):
        _eq(want, S.msm_scan_table_sames(from_numpy_u32(tables[0]), pidx_t,
                                         torch.from_numpy(sames)))


def test_msm_scan_table_signed(tables):
    """Rows of the single table read by index, the sign in bit 1: the JAX
    package gathers them and scans them with msm_scan_rm_signed."""
    pidx, rows, sames, sign = _table_scan_inputs(41, tables[1])
    bits = sames | (sign << 1)
    want = JS.msm_scan_rm_signed(jnp.asarray(rows), jnp.asarray(bits), interpret=True)
    for pidx_t in _both_layouts(pidx):
        _eq(want, S.msm_scan_table_signed(from_numpy_u32(tables[1]), pidx_t,
                                          torch.from_numpy(bits)))


def test_extract_reconstruct_rows(tables):
    """128 rows, each of the 32 bit patterns four times, in a shuffled
    order; the base rows' padding words are not zero (the output's are)."""
    rng = np.random.default_rng(37)
    n = 128
    base = _point_rows(n, 38)
    base[:, 40:] = rng.integers(0, 1 << 32, size=(n, E.TW - 40), dtype=np.uint64)
    carry = _point_rows(n, 39)
    pair = tables[0][rng.integers(0, tables[0].shape[0], size=2 * n)].reshape(n, 2 * S.TWR)
    bits = rng.permutation(np.arange(n) % 32).astype(np.int32)
    want = JE.extract_reconstruct_rows(jnp.asarray(base), jnp.asarray(pair), jnp.asarray(bits),
                                       jnp.asarray(carry), interpret=True)
    _eq(want, E.extract_reconstruct_rows(from_numpy_u32(base), from_numpy_u32(pair),
                                         torch.from_numpy(bits), from_numpy_u32(carry)))


# ---------------------------------------------------------------------------
# The slice: window_group_bucket_sums in every configuration.


@pytest.fixture(scope="module")
def jax_buckets():
    """One eager JAX run of the default configuration at n=128, c=8, all 32
    windows in one group (4096 entries, 128 fragments)."""
    pts, scalars = random_points_scalars(128, seed=79)
    coords = np.stack([ints_to_u32_words([p.x for p in pts]),
                       ints_to_u32_words([p.y for p in pts])], axis=1)
    sc = ints_to_u32_words(scalars)
    table = JMP.build_full_table(jnp.asarray(coords), interpret=True)
    digits = JCV.decompose_scalars_signed(jnp.asarray(sc), CFG)
    buckets = JMP.window_group_bucket_sums(table, digits.T, CFG.num_buckets, interpret=True)
    return {"coords": coords, "sc": sc, "buckets": np.asarray(buckets)}


#: Configuration -> (module switches, fused, the wrappers its branch calls,
#: equal bit for bit (else as points)).
CONFIGS = {
    "default": ({}, False, {"scan_fused"}, True),
    "pret": ({"_SCAN_LAYOUT": "pret"}, False, {"scan_pret"}, True),
    "pret_keys": ({"_SCAN_LAYOUT": "pret", "_SCAN_SAMES": False}, False, {"scan_pret_keys"},
                  True),
    "quarter_store": ({"_SCAN_QSTORE": True}, False, {"scan_q", "extract_reconstruct"}, True),
    "quarter_store_dma_extract": ({"_SCAN_QSTORE": True, "_DMA_EXTRACT": True}, False,
                                  {"scan_q", "extract_reconstruct", "gather"}, True),
    "fused": ({}, True, {"scan_fused"}, True),
    "dma_extract": ({"_DMA_EXTRACT": True}, False, {"scan_fused", "gather"}, True),
    "dma_gather_from_0_rows": ({"_SCAN_QSTORE": True, "_DMA_GATHER_MIN_ROWS": 0}, False,
                               {"scan_q", "extract_reconstruct", "gather"}, True),
    "single_rm": ({"_SINGLE_TABLE": True}, False, {"scan_table_signed"}, False),
    "single_pret": ({"_SINGLE_TABLE": True, "_SCAN_LAYOUT": "pret"}, False,
                    {"scan_pret_signed"}, False),
    "sort_i64": ({"_SORT_I64": True}, False, {"scan_fused"}, False),
}
SCANS = {"scan", "scan_signed", "scan_keys", "scan_pret_keys", "scan_pret", "scan_pret_signed",
         "scan_q", "scan_fused", "scan_table", "scan_table_signed"}


def _points_of(rows: np.ndarray):
    return [p.to_affine() for p in packed_rows_to_extpoints(rows)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bucket_sums_configuration_matches_jax(jax_buckets, monkeypatch, name):
    switches, fused, called, exact = CONFIGS[name]
    for attr, value in switches.items():
        monkeypatch.setattr(MP, attr, value)
    table = MP.build_prod_table(from_numpy_u32(jax_buckets["coords"]))
    assert table.shape[0] == (128 if MP._SINGLE_TABLE else 256)
    digits = decompose_scalars_signed(from_numpy_u32(jax_buckets["sc"]), CFG)
    _build.captures = {}
    try:
        got = MP.window_group_bucket_sums(table, digits.T.contiguous(), CFG.num_buckets,
                                          fused=fused)
        ran = set(_build.captures)
    finally:
        _build.captures = None
    assert called <= ran and not (SCANS - called) & ran, ran
    if "gather" not in called:
        assert "gather" not in ran
    if exact:
        _eq(jax_buckets["buckets"], got)
    else:
        assert _points_of(to_numpy_u32(got)) == _points_of(jax_buckets["buckets"])


def test_default_reads_rows_in_the_scan(jax_buckets, monkeypatch):
    """The doubled-table default copies no row into scan order: with the
    gather kernel and the index path made to raise, and the gather gate
    open at 0 rows, its bucket rows still equal the JAX default's."""
    def refuse(*args):
        raise AssertionError("the default copied the rows into scan order")

    monkeypatch.setattr(MP, "row_gather", refuse)
    monkeypatch.setattr(MP, "_gathered_rows", refuse)
    monkeypatch.setattr(MP, "_DMA_GATHER_MIN_ROWS", 0)
    table = MP.build_prod_table(from_numpy_u32(jax_buckets["coords"]))
    digits = decompose_scalars_signed(from_numpy_u32(jax_buckets["sc"]), CFG)
    _eq(jax_buckets["buckets"],
        MP.window_group_bucket_sums(table, digits.T.contiguous(), CFG.num_buckets))


def test_fused_refuses_the_single_table(jax_buckets):
    table = CV.build_table(from_numpy_u32(jax_buckets["coords"]))
    digits = decompose_scalars_signed(from_numpy_u32(jax_buckets["sc"]), CFG)
    with pytest.raises(ValueError, match="doubled"):
        MP.window_group_bucket_sums(table, digits.T.contiguous(), CFG.num_buckets, fused=True)


def test_single_table_sizing_matches_jax(monkeypatch):
    """default_window_group and default_block_size count a table of n rows
    under the single table, as the JAX package's do."""
    for mod in (MP, JMP):
        monkeypatch.setattr(mod, "_SINGLE_TABLE", True)
    assert MP.default_window_group(1 << 22, 16, "cpu") == JMP.default_window_group(1 << 22, 16)
    assert MP.default_block_size(1 << 23, "cpu") == JMP.default_block_size(1 << 23) == 1 << 22


@pytest.mark.parametrize("switches", [{"_SCAN_QSTORE": True},
                                      {"_SINGLE_TABLE": True, "_SCAN_LAYOUT": "pret"}],
                         ids=["quarter_store", "single_pret"])
def test_compute_msm_configuration_matches_reference(monkeypatch, switches):
    """n = 512, c = 8 through the entry point, against python-int bucket
    sums."""
    for attr, value in switches.items():
        monkeypatch.setattr(MP, attr, value)
    pts, scalars = random_points_scalars(512, seed=81)
    points = [(p.x, p.y) for p in pts]
    got = compute_msm(points, scalars, chunk_size=8, device="cpu")
    assert (got["x"], got["y"]) == _reference_msm(points, scalars)
