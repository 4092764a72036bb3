// The noise kernel that csrc/noise.cu replaced (fedml_tpu_torch/obs/
// ablate_noise.py keeps it as WAS_SOURCE) runs on the host, with the entry
// point of emu_noise.cpp: a thread per element, 256-thread blocks.
#include "noise_emu.cpp"

extern "C" {

int emu_noise(const void* x, const void* noise, float sigma, void* out, int length, int,
              unsigned seed) {
  const unsigned grid = (length + kThreads - 1) / kThreads;
  emu_launch(dim3(grid), dim3(kThreads), emu_shuffled(grid, seed), [&] {
    gaussian_noise_kernel((const float*)x, (const float*)noise, sigma, (float*)out,
                          (unsigned)length);
  });
  return 0;
}

}  // extern "C"
