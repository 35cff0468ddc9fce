"""Benchmarks of the port: the end-to-end benchmark, the per-stage and
arithmetic micro-benchmarks and the dashboard that races every MSM, as a
CLI:

    python -m webgpu_msm_twisted_edwards_tpu_torch.benchmarks full --powers 16 20
    python -m webgpu_msm_twisted_edwards_tpu_torch.benchmarks mont
    python -m webgpu_msm_twisted_edwards_tpu_torch.benchmarks dashboard --power 12
    python -m webgpu_msm_twisted_edwards_tpu_torch.benchmarks full --powers 9 --device cpu
    python -m webgpu_msm_twisted_edwards_tpu_torch.benchmarks scaling --power 20 --mode batch
    ... (`--help` lists every subcommand)

Every subcommand runs on the CUDA card unless `--device cpu` is given.
"""
