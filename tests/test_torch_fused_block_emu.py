"""The fused kernels' own CUDA source, run on the CPU.

``tests/cuda_emu/`` emulates the CUDA features ``csrc/fused_block.cu`` uses
(threads, barriers, warp shuffles, shared memory, the ticket atomic) on the
host, and g++ builds the kernel's source against it with the launches and
the inline PTX atomic replaced by their host forms.  The blocks of a grid
run one after another, in an order shuffled by a seed, so a different block
draws the last ticket in each run.  This holds the kernel's indexing, its
in-block and cross-block folds and its ticket reset against the plain
version before any card run, and the forward kernel's indexing (vector
and scalar variants, channel tiles, one block and many, misaligned
operands) likewise; ``tests/test_torch_cuda.py`` holds the built kernels
on the card.

Tolerances: the forward's out bitwise (the same f32 math, one rounding to
bf16); dy / dr bitwise; d_scale / d_shift within 1e-5 * sum|terms| per
channel (f32 sums in another order); every output bitwise the same for two
block orders.
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
def emu_source(tmp_path_factory):
    """The kernel source with launches and inline PTX replaced by their host
    forms, in a directory of its own (once per module)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation of the kernel")
    src = (ROOT / "fedml_tpu_torch" / "csrc" / "fused_block.cu").read_text()
    src = re.sub(r"<<<[^>]*>>>", "", src)
    src, n = re.subn(r'asm volatile\("([a-z0-9_.]+)[^"]*".*?\);', lambda m: HOST_FORMS[m.group(1)],
                     src, flags=re.S)
    assert n == len(HOST_FORMS), "one inline PTX statement of each kind listed"
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "fused_block_emu.cpp").write_text(src)
    return out


def _build(out, entry: str) -> ctypes.CDLL:
    lib = out / f"lib{entry}.so"
    subprocess.run([shutil.which("g++"), "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-I", str(EMU), "-I", str(out), "-o", str(lib),
                    str(EMU / f"{entry}.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def emu(emu_source):
    """The backward kernel built for the host emulation (once per module)."""
    so = _build(emu_source, "emu_bwd")
    so.emu_fused_bwd.restype = ctypes.c_int
    so.emu_fused_bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_uint]
    return so


@pytest.fixture(scope="module")
def emu_fwd(emu_source):
    """The forward kernel built for the host emulation (once per module)."""
    so = _build(emu_source, "emu_fwd")
    so.emu_fused_fwd.restype = ctypes.c_int
    so.emu_fused_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_uint]
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


# (shape, dtype, SMs, blocks a SM, aligned): the vector variant (C = 16, 24,
# 64 in both dtypes; C = 12 and 300 in f32), the scalar one (C = 3 and 12 in
# bf16, C = 300 in bf16 with channel tiles on blockIdx.y, misaligned
# operands), one block and many
FWD_CASES = [
    ((2, 5, 5, 16), torch.float32, 3, 2, True),
    ((2, 5, 5, 16), torch.bfloat16, 3, 2, True),
    ((2, 5, 5, 24), torch.float32, 3, 2, True),
    ((2, 5, 5, 24), torch.bfloat16, 3, 2, True),
    ((4, 8, 8, 64), torch.bfloat16, 132, 8, True),
    ((4, 8, 8, 64), torch.float32, 132, 8, True),
    ((3, 5, 7, 3), torch.bfloat16, 4, 2, True),
    ((3, 5, 7, 12), torch.bfloat16, 4, 2, True),
    ((3, 5, 7, 12), torch.float32, 4, 2, True),
    ((2, 3, 3, 300), torch.bfloat16, 4, 2, True),
    ((2, 3, 3, 300), torch.float32, 4, 2, True),
    ((4, 8, 8, 16), torch.bfloat16, 4, 4, False),
    ((4, 8, 8, 16), torch.float32, 4, 4, False),
    ((1, 2, 3, 16), torch.bfloat16, 1, 1, True),
]


def _at(t, misaligned: bool):
    """t, or a contiguous copy of it one element past a 16-byte line."""
    if not misaligned:
        return t
    base = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = base[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape,dtype,sm_count,blocks_per_sm,aligned", FWD_CASES)
def test_emulated_forward_matches_plain_version(emu_fwd, shape, dtype, sm_count, blocks_per_sm,
                                                aligned, residual):
    """The forward kernel's source, on the geometry the wrapper would give
    it, equals the plain version bitwise for two block orders (every element
    written once: the output starts as NaN)."""
    from fedml_tpu_torch.ops import fused_block as fb

    rs = np.random.RandomState(sum(shape) + residual)
    c = shape[-1]
    y, r = (_at(torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype), not aligned)
            for _ in range(2))
    s, b = (torch.from_numpy(rs.randn(c).astype(np.float32)) for _ in range(2))
    geo = fb.fwd_geometry(y.numel() // c, c, dtype.itemsize, aligned, sm_count, blocks_per_sm)
    assert (geo.vec > 1) == (aligned and c % (16 // dtype.itemsize) == 0)
    args = (ctypes.c_int * 9)(fb._DTYPE_CODES[dtype], *geo)
    want = fb.fused_block_reference(y, s, b, r if residual else None)
    for seed in (1, 2):
        out = _at(torch.full(shape, float("nan"), dtype=dtype), not aligned)
        rc = emu_fwd.emu_fused_fwd(args, y.data_ptr(), s.data_ptr(), b.data_ptr(),
                                   r.data_ptr() if residual else None, out.data_ptr(), seed)
        assert rc == 0, "no instance"
        assert torch.equal(out, want), (seed, geo)
