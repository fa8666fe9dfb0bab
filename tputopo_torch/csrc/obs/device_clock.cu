// The GPU's global nanosecond timer added to a running sum on the device:
// instrumentation for a tracer, not a kernel of the port (it replaces and
// computes nothing of the reference).
//
// Launched with sign -1 where a stretch of device work starts and +1 where
// it ends, on the one stream that runs the work, the sum grows by the
// stretch's device time every time the pair runs, also when a CUDA graph
// replays the two launches: stream order starts each launch only after the
// work before it has finished.  The sum is read back only when someone asks
// for it, so timing a stretch this way never waits for the device.

#include <cuda_runtime.h>

__global__ void device_clock_kernel(unsigned long long* acc, long long sign) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  // two's complement: adding -now as an unsigned value subtracts it
  atomicAdd(acc, static_cast<unsigned long long>(sign * static_cast<long long>(now)));
}

extern "C" int tputopo_device_clock(void* acc, int sign, float unused, void* stream) {
  (void)unused;
  if (sign != 1 && sign != -1) return static_cast<int>(cudaErrorInvalidValue);
  device_clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(acc), sign);
  return static_cast<int>(cudaGetLastError());
}
