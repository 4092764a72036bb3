"""The fused backward kernel's own CUDA source, run on the CPU.

``tests/cuda_emu/`` emulates the CUDA features ``csrc/fused_block.cu`` uses
(threads, barriers, warp shuffles, shared memory, the ticket atomic) on the
host, and g++ builds the kernel's source against it with the launches and
the inline PTX atomic replaced by their host forms.  The blocks of a grid
run one after another, in an order shuffled by a seed, so a different block
draws the last ticket in each run.  This holds the kernel's indexing, its
in-block and cross-block folds and its ticket reset against the plain
version before any card run; ``tests/test_torch_cuda.py`` holds the built
kernel on the card.

Tolerances: dy / dr bitwise (the same f32 math, one rounding to bf16);
d_scale / d_shift within 1e-5 * sum|terms| per channel (f32 sums in
another order); every output bitwise the same for two block orders.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
EMU = Path(__file__).resolve().parent / "cuda_emu"
# the kernel source's inline PTX, by opcode, and its host form: the ticket
# draw is an atomic add
HOST_FORMS = {"atom.acq_rel.gpu.global.add.u32": "old = atomicAdd(ticket, 1u);"}


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernel built for the host emulation (once per module)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation of the kernel")
    src = (ROOT / "fedml_tpu_torch" / "csrc" / "fused_block.cu").read_text()
    src = re.sub(r"<<<[^>]*>>>", "", src)
    src, n = re.subn(r'asm volatile\("([a-z0-9_.]+)[^"]*".*?\);', lambda m: HOST_FORMS[m.group(1)],
                     src, flags=re.S)
    assert n == len(HOST_FORMS), "one inline PTX statement of each kind listed"
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "fused_block_emu.cpp").write_text(src)
    lib = out / "libemu_bwd.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-pthread", "-I", str(EMU), "-I", str(out), "-o", str(lib),
                    str(EMU / "emu_bwd.cpp")], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.emu_fused_bwd.restype = ctypes.c_int
    so.emu_fused_bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_uint]
    return so


# (shape, dtype, residual, SMs, blocks a SM, aligned): the shuffle and the
# shared-tree in-block folds, 16- and 4-byte cross-block folds, channel
# tiles on blockIdx.y, the scalar variant, one block and many
CASES = [
    ((2, 5, 5, 24), torch.float32, True, 3, 2, True),
    ((2, 5, 5, 24), torch.bfloat16, False, 3, 2, True),
    ((3, 5, 7, 12), torch.bfloat16, True, 3, 2, True),
    ((2, 3, 3, 300), torch.bfloat16, True, 4, 2, True),
    ((2, 3, 3, 300), torch.float32, False, 4, 2, True),
    ((4, 8, 8, 16), torch.bfloat16, True, 4, 4, False),
    ((4, 32, 32, 16), torch.bfloat16, True, 132, 2, True),
    ((8, 8, 8, 64), torch.float32, False, 132, 4, True),
    ((4, 8, 8, 3), torch.float32, True, 4, 2, True),
]


@pytest.mark.parametrize("shape,dtype,residual,sm_count,blocks_per_sm,aligned", CASES)
def test_emulated_backward_matches_plain_version(emu, shape, dtype, residual, sm_count,
                                                 blocks_per_sm, aligned):
    from fedml_tpu_torch.ops import fused_block as fb

    rs = np.random.RandomState(sum(shape))
    c = shape[-1]
    y, r, g = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype) for _ in range(3))
    s, b = (torch.from_numpy(rs.randn(c).astype(np.float32)) for _ in range(2))
    out = fb.fused_block_reference(y, s, b, r if residual else None)
    geo = fb.bwd_geometry(y.numel() // c, c, dtype.itemsize, aligned, sm_count, blocks_per_sm)
    args = (ctypes.c_int * 9)(fb._DTYPE_CODES[dtype], *geo)
    runs = []
    for seed in (1, 2):
        dy = torch.empty_like(y)
        dr = torch.empty_like(y) if residual else None
        dss = torch.full((2, c), float("nan"))
        work = torch.full((geo.scratch_floats,), float("nan"))
        rc = emu.emu_fused_bwd(args, g.data_ptr(), y.data_ptr(), s.data_ptr(), out.data_ptr(),
                               dy.data_ptr(), dr.data_ptr() if residual else None,
                               dss.data_ptr(), work.data_ptr(), seed)
        assert rc == 0, "no instance" if rc == 1 else "a ticket was left set"
        runs.append((dy, dss, dr))
    want = fb.fused_block_bwd_reference(g, y, s, out, residual)
    dy, dss, dr = runs[0]
    assert torch.equal(dy, want[0])
    if residual:
        assert torch.equal(dr, want[3])
    gm = g.float() * (out > 0).float()
    for i, terms in ((0, (gm * y.float()).abs()), (1, gm.abs())):
        bound = 1e-5 * terms.reshape(-1, c).sum(0) + 1e-30
        assert bool(((dss[i] - want[1 + i]).abs() <= bound).all()), i
    for other in runs[1:]:
        assert torch.equal(other[0], dy) and torch.equal(other[1], dss)
        assert not residual or torch.equal(other[2], dr)
