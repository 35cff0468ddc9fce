"""The port's row-moving probes (experiments/dma_gather_probe.py,
fused_gather_probe.py, partition_probe.py) against the JAX probes on the
CPU, bit for bit (tolerance 0) on the outputs each kernel writes.

The JAX probe functions run unedited, imported from experiments/, in the TPU
interpreter: the gathers and scans at NF = 8 fragments over a table of 256
random 13-bit rows, the partition at n = 2048 rows into 4 bins (tblk 512).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from webgpu_msm_twisted_edwards_tpu_torch.experiments import dma_gather_probe as DP
from webgpu_msm_twisted_edwards_tpu_torch.experiments import fused_gather_probe as GP
from webgpu_msm_twisted_edwards_tpu_torch.experiments import partition_probe as PP
from webgpu_msm_twisted_edwards_tpu_torch.experiments import scan_out_probe as OP
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as S
from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32, to_numpy_u32

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "experiments"))
import dma_gather_probe as JDP  # noqa: E402
import fused_gather_probe as JGP  # noqa: E402
import partition_probe as JPP  # noqa: E402

NF, NT = 8, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions issue many small tensor ops; with several test
    workers sharing the cores, torch's intra-op threads would mostly wait on
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    """A table of random 13-bit rows [NT, TWR]; per step and fragment a row
    index, a sorted key (in runs), its same bit and a sign word."""
    rng = np.random.default_rng(43)
    table = rng.integers(0, 1 << 13, size=(NT, 128), dtype=np.int64).astype(np.uint32)
    pidx_t = rng.integers(0, NT, size=(S.K, NF)).astype(np.int32)
    keys = np.sort(rng.integers(0, 8, size=(S.K, NF)), axis=0).astype(np.int32)
    sgn = (rng.random((S.K, NF)) < 0.5).astype(np.int32)
    sames = to_numpy_u32(S.keys_to_sames(torch.from_numpy(keys))).view(np.int32)
    return {"table": table, "pidx_t": pidx_t, "keys": keys, "sgn": sgn, "sames": sames}


def _t(a: np.ndarray) -> torch.Tensor:
    return from_numpy_u32(a) if a.dtype == np.uint32 else torch.from_numpy(a)


def _eq(want, got: torch.Tensor) -> None:
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


def test_dma_gather_matches_jax(inputs):
    with pltpu.force_tpu_interpret_mode():
        want = JDP.dma_gather(jnp.asarray(inputs["table"]), jnp.asarray(inputs["pidx_t"]))
    got = DP.dma_gather(_t(inputs["table"]), _t(inputs["pidx_t"]))
    _eq(want, got)
    assert got.shape == (NF * S.K, 128)


def test_msm_scan_dma_matches_jax(inputs):
    """Equal to the JAX DMA scan, and to msm_scan_rm_sames on the gathered
    rows."""
    with pltpu.force_tpu_interpret_mode():
        want = JDP.msm_scan_dma(jnp.asarray(inputs["table"]), jnp.asarray(inputs["pidx_t"]),
                                jnp.asarray(inputs["sames"]))
    table, pidx_t, sames = _t(inputs["table"]), _t(inputs["pidx_t"]), _t(inputs["sames"])
    got = DP.msm_scan_dma(table, pidx_t, sames)
    _eq(want, got)
    rows = DP.dma_gather(table, pidx_t).reshape(NF, S.K, 128)
    assert torch.equal(got, S.msm_scan_rm_sames(rows, sames))


@pytest.fixture(scope="module")
def jax_fused(inputs):
    """The JAX probe's copy-only and fused kernels (lblk = NF), run once.
    Its scan-only kernel reads a scratch that nothing writes, so it has no
    defined output to compare."""
    args = [jnp.asarray(inputs[k]) for k in ("pidx_t", "table", "keys", "sgn")]
    with pltpu.force_tpu_interpret_mode():
        out = {}
        for name, kern in (("copy", JGP.kern_copy), ("fused", JGP.kern_fused)):
            fn, consts = JGP.build(kern, NT, NF, lblk=NF)
            out[name] = np.asarray(fn(consts, *args))
    return out


def test_gather_copy_matches_jax(inputs, jax_fused):
    """out[:, 0, :] only: the rest is not written (0xFFFFFFFF in the
    interpreter, zero in the plain version)."""
    got = GP.gather_copy(_t(inputs["table"]), _t(inputs["pidx_t"]))
    assert got.shape == (NF, S.K, 64)
    _eq(jax_fused["copy"][:, 0], got[:, 0])
    assert not got[:, 1:].any()


def test_gather_fused_matches_jax(inputs, jax_fused):
    """Fused equals the JAX fused kernel, and out64 on the gathered rows."""
    table, pidx_t = _t(inputs["table"]), _t(inputs["pidx_t"])
    keys, sgn = _t(inputs["keys"]), _t(inputs["sgn"])
    got = GP.gather_fused(table, pidx_t, keys, sgn)
    _eq(jax_fused["fused"], got)
    rows = DP.dma_gather(table, pidx_t).reshape(NF, S.K, 128)
    assert torch.equal(got, OP.scan_out(rows, keys, sgn, 1))


def test_gather_scan_is_the_scan_phase_of_fused(inputs, jax_fused):
    """Scan-only over the rows in step order equals the JAX fused kernel."""
    staged = GP.stage_rows(_t(inputs["table"]), _t(inputs["pidx_t"]))
    assert staged.shape == (S.K, NF, 128)
    _eq(jax_fused["fused"], GP.gather_scan(staged, _t(inputs["keys"]), _t(inputs["sgn"])))


def _numpy_partition(rows: np.ndarray, bins: np.ndarray, nbins: int):
    """Per bin, its rows in input order and the row count of its full
    tiles within cap."""
    cap = rows.shape[0] // nbins * 2
    per = [rows[bins == b] for b in range(nbins)]
    return cap, per, [min(len(p) // 64, cap // 64) * 64 for p in per]


@pytest.fixture(scope="module")
def part_inputs():
    rng = np.random.default_rng(44)
    n, nbins = 2048, 4
    rows = rng.integers(0, 1 << 13, size=(n, 128), dtype=np.int64).astype(np.uint32)
    bins = rng.integers(0, nbins, size=n).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JPP.partition(jnp.asarray(rows), jnp.asarray(bins), nbins, tblk=512))
    return rows, bins, nbins, want


@pytest.mark.parametrize("stray", [False, True], ids=["binned", "stray_bins"])
def test_partition_matches_a_stable_partition(part_inputs, stray):
    """Every full tile holds its bin's rows in input order; the rest of the
    output is not written (zero in the plain version).  A row whose bin lies
    outside [0, nbins) goes nowhere (the kernels check no bin on the host)."""
    rows, bins, nbins, _ = part_inputs
    if stray:
        bins = bins.copy()
        bins[::7], bins[3::11] = nbins, -1
    got = to_numpy_u32(PP.partition(_t(rows), _t(bins), nbins, tblk=512))
    cap, per, full = _numpy_partition(rows, bins, nbins)
    assert got.shape == (nbins * cap, 128) and min(full) > 64
    mask = PP.written(_t(bins), nbins).numpy()
    for b in range(nbins):
        np.testing.assert_array_equal(got[b * cap:b * cap + full[b]], per[b][:full[b]])
        assert mask[b * cap:(b + 1) * cap].sum() == full[b]
    assert not got[~mask].any()


def test_partition_matches_jax_past_tile_0(part_inputs):
    """Tiles 1 and up equal the JAX probe's.  Its tile 0 in the interpreter
    holds the bin's last flushed tile or rows mixed with the tail: the
    probe's drain and wait descriptors name out[b*cap : b*cap+64] as their
    destination."""
    rows, bins, nbins, want = part_inputs
    got = to_numpy_u32(PP.partition(_t(rows), _t(bins), nbins, tblk=512))
    cap, _, full = _numpy_partition(rows, bins, nbins)
    for b in range(nbins):
        np.testing.assert_array_equal(got[b * cap + 64:b * cap + full[b]],
                                      want[b * cap + 64:b * cap + full[b]])


@pytest.mark.parametrize("probe", [DP, GP, PP], ids=["dma_gather", "fused_gather", "partition"])
def test_main_without_a_card_raises(monkeypatch, probe):
    """A probe runs on the card unless --device cpu is given: no silent
    fallback to the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])


def test_partition_main_on_the_cpu(capsys):
    """The probe's main end to end on the plain versions, at a small size."""
    out = PP.main(["--device", "cpu", "--n", "4096", "--bins", "4", "--tblk", "512"])
    assert set(out["ms"]) == {"partition", "gather kernel"}
    assert 0 < out["rows_written"] <= 4096
    assert "M rows/s" in capsys.readouterr().out
