"""The benchmark of the PyTorch/CUDA MSM port on one H100.

One run of one cell:

    python3 -m msmbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, metrics and bounds are in
BENCHMARK.json; each configuration, traffic mix and per-layer metric is a
file of its own under this folder, found by its name (README.md).  The
benchmark drives only the port's public entry points and never imports JAX
or the JAX package.
"""

#: The package under test.
PORT = "webgpu_msm_twisted_edwards_tpu_torch"

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "webgpu_msm_twisted_edwards_tpu")
