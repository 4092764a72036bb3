// The central-DP noise kernel of fedml_tpu_torch/csrc/noise.cu runs on the
// host (tests/test_torch_noise_emu.py builds this with the kernel's source,
// launches stripped, as noise_emu.cpp).
#include "noise_emu.cpp"

extern "C" {

// The launch gaussian_noise makes, its thread blocks in an order shuffled by
// `seed`.
int emu_noise(const void* x, const void* noise, float sigma, void* out, int length, int vec,
              unsigned seed) {
  const unsigned n = (unsigned)length, grid = noise_grid(n);
  const float* xs = (const float*)x;
  const float* ns = (const float*)noise;
  float* o = (float*)out;
  emu_launch(dim3(grid), dim3(kThreads), emu_shuffled(grid, seed), [&] {
    if (vec) gaussian_noise_kernel<true>(xs, ns, sigma, o, n);
    else gaussian_noise_kernel<false>(xs, ns, sigma, o, n);
  });
  return 0;
}

// The C entry's launch at `length`: {grid, threads a block, elements a tile}.
void emu_geometry(unsigned length, unsigned* geo) {
  geo[0] = noise_grid(length);
  geo[1] = kThreads;
  geo[2] = kTile;
}

}  // extern "C"
