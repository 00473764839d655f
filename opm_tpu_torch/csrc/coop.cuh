// The grid of a cooperative launch, shared by the kernels that launch over
// every co-resident block with grid barriers between phases (gmg.cu,
// amg.cu): the device's SM count, refused where the device has no
// cooperative launch, and a kernel's grid from the occupancy query.

#pragma once

#include <cuda_runtime.h>

namespace opm_coop {

// the current device's SM count, or a CUDA error where it has no
// cooperative launch
inline cudaError_t coop_sms(int* nsm) {
    int dev = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev);
    if (err == cudaSuccess && !coop) err = cudaErrorCooperativeLaunchTooLarge;
    return err;
}

// the cooperative grid of kernel k at threads per block for work threads'
// worth on nsm SMs (at most the co-resident blocks, at most what the work
// needs), with its co-resident blocks per SM and registers per thread
inline cudaError_t coop_grid(const void* k, int threads, long long work,
                             int nsm, int* grid, int* nb, int* regs) {
    cudaFuncAttributes fa;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(nb, k, threads, 0);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return err;
    if (*nb < 1) return cudaErrorCooperativeLaunchTooLarge;
    long long g = (long long)*nb * nsm;
    const long long need = (work + threads - 1) / threads;
    if (need < g) g = need;
    *grid = (int)(g < 1 ? 1 : g);
    *regs = fa.numRegs;
    return cudaSuccess;
}

}  // namespace opm_coop
