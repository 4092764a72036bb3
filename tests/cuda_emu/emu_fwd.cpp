// The fused forward kernel of fedml_tpu_torch/csrc/fused_block.cu run on the
// host (tests/test_torch_fused_block_emu.py builds this with the kernel's
// source, launches and inline PTX stripped, as fused_block_emu.cpp).
#include <algorithm>
#include <random>

#include "fused_block_emu.cpp"

namespace {

template <typename T, int VEC, bool R>
void run(const int* geo, unsigned lanes, const void* y, const void* scale, const void* shift,
         const void* res, void* out, unsigned seed) {
  RowArgs a{(unsigned)geo[1], (unsigned)geo[2], (unsigned)geo[4], (unsigned)geo[8], 0u};
  const dim3 grid(geo[6], geo[7], lanes), block(geo[4], geo[5]);
  std::vector<unsigned> order(grid.x * grid.y * grid.z);
  for (unsigned i = 0; i < order.size(); ++i) order[i] = i;
  std::mt19937 rng(seed);
  std::shuffle(order.begin(), order.end(), rng);
  emu_launch(grid, block, order, [&] {
    fwd_kernel<T, VEC, R>((const T*)y, (const float*)scale, (const float*)shift, (const T*)res,
                          (T*)out, a);
  });
}

}  // namespace

extern "C" {

// geo: the int array fused_fwd_lanes takes, for `lanes` lane-major lanes;
// blocks run in an order shuffled by `seed`.  Returns 0, or 1 for a variant
// it has no instance of.
int emu_fused_fwd_lanes(const int* geo, unsigned lanes, const void* y, const void* scale,
                        const void* shift, const void* res, void* out, unsigned seed) {
  const int dtype = geo[0], vec = geo[3];
#define EMU_RUN(T, V)                                                      \
  (res ? run<T, V, true>(geo, lanes, y, scale, shift, res, out, seed) \
       : run<T, V, false>(geo, lanes, y, scale, shift, res, out, seed))
  if (dtype == 0 && vec == 4) EMU_RUN(float, 4);
  else if (dtype == 0 && vec == 1) EMU_RUN(float, 1);
  else if (dtype == 1 && vec == 8) EMU_RUN(__nv_bfloat16, 8);
  else if (dtype == 1 && vec == 1) EMU_RUN(__nv_bfloat16, 1);
  else return 1;
#undef EMU_RUN
  return 0;
}

// One lane (the int array fused_fwd takes).
int emu_fused_fwd(const int* geo, const void* y, const void* scale, const void* shift,
                  const void* res, void* out, unsigned seed) {
  return emu_fused_fwd_lanes(geo, 1, y, scale, shift, res, out, seed);
}

}  // extern "C"
