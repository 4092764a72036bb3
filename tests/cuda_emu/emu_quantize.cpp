// The int8 quantize and dequantize kernels of fedml_tpu_torch/csrc/quantize.cu
// run on the host (tests/test_torch_quantize_emu.py builds this with the
// kernels' source, launches stripped, as quantize_emu.cpp).
#include "quantize_emu.cpp"

extern "C" {

// The launch quantize_int8 makes: a thread block per quantization block.
int emu_quantize(const void* x, const void* u, void* values, void* scales, int length, int vec,
                 unsigned seed) {
  const unsigned grid = quantize_grid((unsigned)length);
  emu_launch(dim3(grid), dim3(kThreads), emu_shuffled(grid, seed), [&] {
    if (vec)
      quantize_kernel<true>((const float*)x, (const float*)u, (signed char*)values,
                            (float*)scales, (unsigned)length);
    else
      quantize_kernel<false>((const float*)x, (const float*)u, (signed char*)values,
                             (float*)scales, (unsigned)length);
  });
  return 0;
}

// The launch dequantize_int8 makes.
int emu_dequantize(const void* values, const void* scales, void* out, int length, int vec,
                   unsigned seed) {
  const unsigned grid = dequantize_grid((unsigned)length);
  emu_launch(dim3(grid), dim3(kDqThreads), emu_shuffled(grid, seed), [&] {
    if (vec)
      dequantize_kernel<true>((const signed char*)values, (const float*)scales, (float*)out,
                              (unsigned)length);
    else
      dequantize_kernel<false>((const signed char*)values, (const float*)scales, (float*)out,
                               (unsigned)length);
  });
  return 0;
}

// The C entries' launch geometry at `length`: {grid, threads a block, values a
// thread block} of the quantize (which = 0) or the dequantize (which = 1).
void emu_geometry(int which, unsigned length, unsigned* geo) {
  if (which == 0) {
    geo[0] = quantize_grid(length);
    geo[1] = kThreads;
    geo[2] = kBlock;
  } else {
    geo[0] = dequantize_grid(length);
    geo[1] = kDqThreads;
    geo[2] = kDqThreads / 32 * kDqSpan;
  }
}

}  // extern "C"
