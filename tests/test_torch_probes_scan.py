"""The port's scan probes (experiments/scan_floor_probe.py,
scan_tune_probe.py, scan_out_probe.py) against the JAX probes on the CPU,
bit for bit (tolerance 0: integer arithmetic) on the outputs each variant
writes.

The JAX probe functions run unedited, imported from experiments/, in the TPU
interpreter at NF = 8 fragments (limb-major blocks of 4).  Rows are random
13-bit limbs, not field elements below 3p, so the lazy subtractions wrap
limb by limb and the carry out of limb 19 is dropped: the plain versions
must follow the JAX package's u32 arithmetic there too.
"""

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import jax_kernel_cache
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from webgpu_msm_twisted_edwards_tpu_torch.experiments import scan_floor_probe as FP
from webgpu_msm_twisted_edwards_tpu_torch.experiments import scan_out_probe as OP
from webgpu_msm_twisted_edwards_tpu_torch.experiments import scan_tune_probe as TP
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as S
from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32, to_numpy_u32

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "experiments"))
import scan_floor_probe as JFP  # noqa: E402
import scan_out_probe as JOP  # noqa: E402
import scan_tune_probe as JTP  # noqa: E402

NF, LBLK = 8, 4


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


@pytest.fixture(scope="module")
def inputs():
    """Random 13-bit rows [NF, K, TWR], sorted keys [K, NF] in runs, their
    same bits, and a sign word per entry."""
    rng = np.random.default_rng(41)
    rows = rng.integers(0, 1 << 13, size=(NF, S.K, 128), dtype=np.int64).astype(np.uint32)
    keys = np.sort(rng.integers(0, 8, size=(S.K, NF)), axis=0).astype(np.int32)
    sgn = (rng.random((S.K, NF)) < 0.5).astype(np.int32)
    sames = to_numpy_u32(S.keys_to_sames(torch.from_numpy(keys))).view(np.int32)
    return {"rows": rows, "keys": keys, "sgn": sgn, "sames": sames,
            "rows_t": np.asarray(JTP.pre_transpose(jnp.asarray(rows), LBLK))}


def _t(a: np.ndarray) -> torch.Tensor:
    return from_numpy_u32(a) if a.dtype == np.uint32 else torch.from_numpy(a)


def _eq(want, got: torch.Tensor) -> None:
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


@pytest.fixture(scope="module")
def jax_floor(inputs):
    """Each set of the JAX floor probe's flags, run once."""
    rows, sames = jnp.asarray(inputs["rows"]), jnp.asarray(inputs["sames"])
    with pltpu.force_tpu_interpret_mode():
        return {flags: np.array(JFP.variant(rows, sames, *flags))
                for flags in set(FP.VARIANTS.values())}


@pytest.mark.parametrize("name", list(FP.VARIANTS))
def test_floor_variant_matches_jax(inputs, jax_floor, name):
    """Every row of full, control, nosel and hoistread; pair 31 of nowrite
    and floor (the interpreter leaves the other rows at 0xFFFFFFFF)."""
    flags = FP.VARIANTS[name]
    got = FP.variant(_t(inputs["rows"]), _t(inputs["sames"]), *flags, control=name == "control")
    assert got.shape == (NF, S.K // 2, 128)
    write = flags[1]
    _eq(FP.defined(torch.from_numpy(jax_floor[flags]), write).numpy(), FP.defined(got, write))
    if name in ("full", "control"):
        assert torch.equal(got, S.msm_scan_rm_sames_plain(_t(inputs["rows"]), _t(inputs["sames"])))
    if not write:
        assert not got[:, :-1].any()


def test_pre_transpose_matches_jax(inputs):
    _eq(inputs["rows_t"], TP.pre_transpose(_t(inputs["rows"]), LBLK))


@pytest.mark.parametrize("name", ["pret", "sames"])
def test_limb_major_scans_match_jax(inputs, name):
    """msm_scan_pret (keys) and msm_scan_sames (hoisted bits) on the probe's
    limb-major layout: the pipeline's kernels of the same names."""
    rows_t = jnp.asarray(inputs["rows_t"])
    with pltpu.force_tpu_interpret_mode():
        if name == "pret":
            want = JTP.msm_scan_pret(rows_t, jnp.asarray(inputs["keys"]))
        else:
            want = JTP.msm_scan_sames(rows_t, jnp.asarray(inputs["sames"]))
    fn, aux = (TP.msm_scan_pret, "keys") if name == "pret" else (TP.msm_scan_sames, "sames")
    got = fn(_t(inputs["rows_t"]), _t(inputs[aux]))
    _eq(want, got)
    assert torch.equal(got, S.msm_scan_plain(_t(inputs["rows"]), _t(inputs["keys"])))


#: Dual variant -> (fuse, pret).
DUALS = {"dual": (False, False), "dualf": (True, False), "pret_dual": (False, True)}


@pytest.mark.parametrize("name", list(DUALS))
def test_dual_matches_jax(inputs, name):
    """Both halves of the two-accumulator scan; without fuse they are
    msm_scan's halves, with fuse the probe's G8 formula gives others."""
    fuse, pret = DUALS[name]
    rows = inputs["rows_t"] if pret else inputs["rows"]
    with pltpu.force_tpu_interpret_mode():
        want = JTP.msm_scan_dual(jnp.asarray(rows), jnp.asarray(inputs["keys"]), LBLK, fuse=fuse,
                                 pret=pret)
    got = TP.msm_scan_dual(_t(rows), _t(inputs["keys"]), fuse=fuse, pret=pret)
    for w, g in zip(want, got):
        _eq(w, g)
    whole = torch.cat(got)
    base = S.msm_scan_plain(_t(inputs["rows"]), _t(inputs["keys"]))
    assert torch.equal(whole, base) != fuse


@pytest.mark.parametrize("store", [1, 2], ids=["out64", "out128"])
def test_scan_out_matches_jax(inputs, store):
    """The sign words negate y-x and 2*d*t of random rows: 4p - v wraps
    limb by limb where v's limbs pass 4p's."""
    kern, steps, width = (JOP.kern64, S.K, 64) if store == 1 else (JOP.kern128, S.K // 2, 128)
    with pltpu.force_tpu_interpret_mode():
        fn, consts = JOP.build(kern, NF, steps, width, lblk=LBLK)
        want = fn(consts, jnp.asarray(inputs["rows"]), jnp.asarray(inputs["keys"]),
                  jnp.asarray(inputs["sgn"]))
    got = OP.scan_out(_t(inputs["rows"]), _t(inputs["keys"]), _t(inputs["sgn"]), store)
    _eq(want, got)
    other = OP.scan_out(_t(inputs["rows"]), _t(inputs["keys"]), _t(inputs["sgn"]), 3 - store)
    assert torch.equal(got.reshape(NF, S.K // 2, 128), other.reshape(NF, S.K // 2, 128))


@pytest.mark.parametrize("probe", [FP, TP, OP], ids=["scan_floor", "scan_tune", "scan_out"])
def test_main_without_a_card_raises(monkeypatch, probe):
    """A probe runs on the card unless --device cpu is given: no silent
    fallback to the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])


@pytest.mark.parametrize("name", ["probe_scan.cuh", "probe_scan.cu", "probe_move.cu"])
def test_probe_scan_header_runs_only_the_inlined_formulas(name):
    """The probes' scans (the two templates of csrc/probe_scan.cuh,
    instantiated by csrc/probe_scan.cu and csrc/probe_move.cu, and the
    fused-gather scans of csrc/probe_move.cu) run the inlined 26-bit madd26
    or madd26_x4 of csrc/ec26.cuh: no file calls a 13-bit madd (a call
    through a stack frame) or a 13-bit madd2, so an instantiation cannot
    fall back to one.  The 13-bit point formulas are gone: csrc/ec.cuh does
    not exist and no source under csrc/ includes it.  The card checks each
    instantiation's frame and calls (chip_smoke.py::INLINED)."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "webgpu_msm_twisted_edwards_tpu_torch", "csrc")
    assert not os.path.exists(os.path.join(csrc, "ec.cuh"))
    for src in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, src)) as f:
            includes = re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M)
        assert "ec.cuh" not in includes, src
    with open(os.path.join(csrc, name)) as f:
        code = re.sub(r"//[^\n]*", "", f.read())
    assert not re.search(r"\bmadd2?\s*\(", code)
    if name != "probe_scan.cu":
        assert re.search(r"\bmadd26(_x4)?\s*\(", code)
