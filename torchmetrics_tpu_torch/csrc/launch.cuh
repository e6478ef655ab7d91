// The lean launch path shared by the kernels whose C entry takes the device
// index (binned_curve.cu, retrieval_topk_stats.cu): a device guard inside the
// entry in place of the wrapper's `with torch.cuda.device(...)`, and the
// runtime queries a launch needs, asked once a device.
//
// A wrapper that is called once a metric update pays for every host
// microsecond it spends; the guard costs one cudaGetDevice when the caller's
// device is already current (the usual case), and the cached queries nothing.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace tm_launch {

constexpr int kMaxDevices = 64;

// Makes `device` current for the entry's lifetime and restores the caller's
// device when the entry returns: torch reads its current device from the
// runtime, so a device left switched would send later work to another card.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&previous_);
    if (err_ == cudaSuccess && previous_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int previous_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

// The SM count of `device`, asked of the runtime once a device and process.
inline cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int value = cache[device].load(std::memory_order_relaxed);
  if (value == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&value, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cache[device].store(value, std::memory_order_relaxed);
  }
  *sms = value;
  return cudaSuccess;
}

}  // namespace tm_launch
