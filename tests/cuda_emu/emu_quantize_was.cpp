// The int8 quantize and dequantize kernels that csrc/quantize.cu replaced
// (fedml_tpu_torch/obs/ablate_quant.py keeps them as WAS_SOURCE) run on the
// host, with the entry points of emu_quantize.cpp: a 256-thread block per
// quantization block, a thread per dequantized element.
#include "quantize_emu.cpp"

extern "C" {

int emu_quantize(const void* x, const void* u, void* values, void* scales, int length, int,
                 unsigned seed) {
  const unsigned blocks = (length + kBlock - 1) / kBlock;
  emu_launch(dim3(blocks), dim3(kThreads), emu_shuffled(blocks, seed), [&] {
    quantize_kernel((const float*)x, (const float*)u, (signed char*)values, (float*)scales,
                    (unsigned)length);
  });
  return 0;
}

int emu_dequantize(const void* values, const void* scales, void* out, int length, int,
                   unsigned seed) {
  const unsigned grid = (length + kThreads - 1) / kThreads;
  emu_launch(dim3(grid), dim3(kThreads), emu_shuffled(grid, seed), [&] {
    dequantize_kernel((const signed char*)values, (const float*)scales, (float*)out,
                      (unsigned)length);
  });
  return 0;
}

}  // extern "C"
