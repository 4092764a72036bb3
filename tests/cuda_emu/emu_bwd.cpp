// The fused backward kernel of fedml_tpu_torch/csrc/fused_block.cu run on the
// host (tests/test_torch_fused_block_emu.py builds this with the kernel's
// source, launches and inline PTX stripped, as fused_block_emu.cpp).
#include <algorithm>
#include <random>

#include "fused_block_emu.cpp"

namespace {

template <typename T, int VEC, bool R>
void run(const int* geo, unsigned lanes, const void* g, const void* y, const void* scale,
         const void* out, void* dy, void* dr, void* dss, void* work, unsigned seed) {
  RowArgs a{(unsigned)geo[1], (unsigned)geo[2], (unsigned)geo[4], (unsigned)geo[8], 7u};
  const dim3 grid(geo[6], geo[7], lanes), block(geo[4] * geo[5]);
  std::vector<unsigned> order(grid.x * grid.y * grid.z);
  for (unsigned i = 0; i < order.size(); ++i) order[i] = i;
  std::mt19937 rng(seed);
  std::shuffle(order.begin(), order.end(), rng);
  emu_launch(grid, block, order, [&] {
    bwd_kernel<T, VEC, R>((const T*)g, (const T*)y, (const float*)scale, (const T*)out, (T*)dy,
                          (T*)dr, (float*)dss, (float*)work, a);
  });
}

}  // namespace

extern "C" {

// geo: the int array fused_bwd_lanes takes, for `lanes` lane-major lanes
// (ticket slots 7 .. 7 + lanes - 1); blocks run in an order shuffled by
// `seed`.  Returns 0, 1 for a variant it has no instance of, or 2 if a
// ticket was left set.
int emu_fused_bwd_lanes(const int* geo, unsigned lanes, const void* g, const void* y,
                        const void* scale, const void* out, void* dy, void* dr, void* dss,
                        void* work, unsigned seed) {
  const int dtype = geo[0], vec = geo[3];
#define EMU_RUN(T, V)                                                                  \
  (dr ? run<T, V, true>(geo, lanes, g, y, scale, out, dy, dr, dss, work, seed) \
      : run<T, V, false>(geo, lanes, g, y, scale, out, dy, dr, dss, work, seed))
  if (dtype == 0 && vec == 4) EMU_RUN(float, 4);
  else if (dtype == 0 && vec == 1) EMU_RUN(float, 1);
  else if (dtype == 1 && vec == 8) EMU_RUN(__nv_bfloat16, 8);
  else if (dtype == 1 && vec == 1) EMU_RUN(__nv_bfloat16, 1);
  else return 1;
#undef EMU_RUN
  for (unsigned t : g_tickets)
    if (t != 0) return 2;
  return 0;
}

// One lane (the int array fused_bwd takes).
int emu_fused_bwd(const int* geo, const void* g, const void* y, const void* scale,
                  const void* out, void* dy, void* dr, void* dss, void* work, unsigned seed) {
  return emu_fused_bwd_lanes(geo, 1, g, y, scale, out, dy, dr, dss, work, seed);
}

}  // extern "C"
