"""ZPrize test-case fixtures: the loader and saver of the demox-labs format,
and the published expected results.

Points live in `<dir>/points/<k>-power-points.txt` as JSON lines
`{"x": "<dec>", "y": "<dec>", "t": "<dec>", "z": "<dec>"}` and scalars in
`<dir>/scalars/<k>-power-scalars.txt` as one decimal integer per line; a
sidecar `<dir>/<k>-power-expected.txt` holds the expected affine result of
generated inputs.  The expected results of the original fixtures for
n = 2^16 ... 2^20 are published constants, kept here; the fixture files are
large and neither vendored nor fetched (`make_fixture` writes compatible
ones from the native oracle's points).  The default directory is the
repository's `test-data/`, which the JAX package reads too.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from .params import P as _P

#: Published expected MSM results of the ZPrize fixture inputs.
EXPECTED_RESULTS: dict[int, tuple[int, int]] = {
    16: (
        4490298471131273381350715833932091894064554978284853693957586604825823442429,
        207233051598812890797414182362695316831408959017076683749810755208551572458,
    ),
    17: (
        405755281347735151880827575059343698498813029460786026451708154294960743560,
        7112985356832152643523650125935205310677117771129806490701829425450717492869,
    ),
    18: (
        4020134989704514076121556080357844499902614818105934254331815581426895427831,
        2694327822589008080344499645494473764166611881342421427746308662023437975766,
    ),
    19: (
        3856727778963570638772781884183843350150969534777451295534564482755471873113,
        1398750101296346671684024297455637342909036274728274942667983346895370713922,
    ),
    20: (
        5201851187583570844529445080011852189038251929148722905178398320328749074909,
        3586360219804356686204324370397321114669962278596135149389460948678051407803,
    ),
}

#: Default fixture root: the repository's test-data/.
DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "test-data")


@dataclass
class TestCase:
    points: list[tuple[int, int]]          # affine (x, y)
    scalars: list[int]
    expected: tuple[int, int] | None


def fixture_paths(power: int, base_dir: str | None = None) -> tuple[str, str]:
    base = base_dir or DEFAULT_DIR
    return (
        os.path.join(base, "points", f"{power}-power-points.txt"),
        os.path.join(base, "scalars", f"{power}-power-scalars.txt"),
    )


def _expected_path(power: int, base_dir: str | None = None) -> str:
    base = base_dir or DEFAULT_DIR
    return os.path.join(base, f"{power}-power-expected.txt")


def available(power: int, base_dir: str | None = None) -> bool:
    pp, sp = fixture_paths(power, base_dir)
    return os.path.exists(pp) and os.path.exists(sp)


def load_test_case(power: int, base_dir: str | None = None) -> TestCase:
    """Parse the demox-labs fixture format."""
    pp, sp = fixture_paths(power, base_dir)
    points = []
    with open(pp) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            points.append((int(obj["x"]), int(obj["y"])))
    with open(sp) as f:
        scalars = [int(line.strip()) for line in f if line.strip()]
    # A sidecar expected-result file (written by make_fixture for generated
    # inputs) takes precedence over the published ZPrize constants, which are
    # only valid for the original fixture inputs.
    ep = _expected_path(power, base_dir)
    if os.path.exists(ep):
        with open(ep) as f:
            ex, ey = (int(v) for v in f.read().split())
        expected = (ex, ey)
    else:
        expected = EXPECTED_RESULTS.get(power)
    return TestCase(points, scalars, expected)


def save_test_case(points, scalars, power: int, base_dir: str | None = None) -> None:
    """Write fixtures in the demox-labs format."""
    pp, sp = fixture_paths(power, base_dir)
    os.makedirs(os.path.dirname(pp), exist_ok=True)
    os.makedirs(os.path.dirname(sp), exist_ok=True)
    with open(pp, "w") as f:
        for x, y in points:
            # Extended form with t = x*y mod p, z = 1, like the source data.
            f.write(json.dumps({"x": str(x), "y": str(y), "t": str(x * y % _P), "z": "1"}) + "\n")
    with open(sp, "w") as f:
        for s in scalars:
            f.write(str(s) + "\n")


def make_fixture(power: int, seed: int = 20230923, base_dir: str | None = None) -> TestCase:
    """Generate a deterministic fixture of 2^power points + scalars with the
    native oracle walk, save it in the demox-labs format, and record the
    oracle's expected result in a sidecar file (so the loader never attaches
    the published ZPrize constants — valid only for the original inputs — to
    generated data)."""
    from . import oracle

    n = 1 << power
    pts_u64 = oracle.gen_points(n, seed=seed)
    points = oracle.points_u64_to_ints(pts_u64)
    rng = np.random.default_rng(seed)
    sc = rng.integers(0, 1 << 62, size=(n, 4), dtype=np.uint64)
    sc[:, 3] &= (1 << 58) - 1
    scalars = [int(a) | int(b) << 64 | int(c) << 128 | int(d) << 192 for a, b, c, d in sc]
    save_test_case(points, scalars, power, base_dir)
    expected = oracle.msm(pts_u64, sc, c=16)
    with open(_expected_path(power, base_dir), "w") as f:
        f.write(f"{expected[0]} {expected[1]}\n")
    return TestCase(points, scalars, expected)

