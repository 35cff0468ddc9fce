"""The port's profile summary: kernel_families groups the per-kernel device
times of utils/profiling.py::device_profile by family (runs on the CPU: it
only reads the summary's records)."""

import pytest

from webgpu_msm_twisted_edwards_tpu_torch.utils.profiling import kernel_families


def test_kernel_families_sum_every_kernel_once():
    kernels = [
        {"name": "void msm::scan_kernel<2, 0, 2>(unsigned int const*, int const*)", "ms": 4.5,
         "count": 1},
        {"name": "msm::masked_add_kernel(unsigned int const*, unsigned int const*)", "ms": 0.25,
         "count": 3},
        {"name": "msm::reduce_rows_kernel(unsigned int const*, unsigned int*, int)", "ms": 0.05,
         "count": 1},
        {"name": "void at::native::vectorized_gather_kernel<16, long>(char*)", "ms": 1.0,
         "count": 2},
        {"name": "void at::native::_scatter_gather_elementwise_kernel<128, 8>()", "ms": 0.5,
         "count": 2},
        {"name": "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>()", "ms": 1.0,
         "count": 90},
        {"name": "void at::native::(anonymous namespace)::CatArrayBatchedCopy<4u>()", "ms": 0.75,
         "count": 4},
        {"name": "Memcpy DtoD (Device -> Device)", "ms": 0.25, "count": 1},
        {"name": "Memset (Device)", "ms": 0.125, "count": 1},
        {"name": "void at::native::vectorized_elementwise_kernel<4, AbsFunctor<int>>()", "ms": 0.5,
         "count": 7},
    ]
    fam = kernel_families(kernels)
    assert fam == {"scan_kernel": [4.5, 1], "torch gathers": [1.5, 4], "sort": [1.0, 90],
                   "torch copies and cat": [1.0, 5], "other torch": [0.625, 8],
                   "masked_add_kernel": [0.25, 3], "reduce_rows_kernel": [0.05, 1]}
    assert list(fam) == sorted(fam, key=lambda k: -fam[k][0])
    assert sum(v[0] for v in fam.values()) == pytest.approx(sum(k["ms"] for k in kernels))
