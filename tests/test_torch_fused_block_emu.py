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
    so.emu_fused_bwd_lanes.restype = ctypes.c_int
    so.emu_fused_bwd_lanes.argtypes = ([ctypes.c_void_p, ctypes.c_uint] + [ctypes.c_void_p] * 8
                                       + [ctypes.c_uint])
    return so


@pytest.fixture(scope="module")
def emu_fwd(emu_source):
    """The forward kernel built for the host emulation (once per module)."""
    so = _build(emu_source, "emu_fwd")
    so.emu_fused_fwd.restype = ctypes.c_int
    so.emu_fused_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_uint]
    so.emu_fused_fwd_lanes.restype = ctypes.c_int
    so.emu_fused_fwd_lanes.argtypes = ([ctypes.c_void_p, ctypes.c_uint] + [ctypes.c_void_p] * 5
                                       + [ctypes.c_uint])
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


# (lane shape, dtype, SMs, blocks a SM): the vector and scalar variants,
# several row blocks a lane (cross-block folds) and channel tiles
LANE_CASES = [
    ((2, 5, 5, 24), torch.float32, 3, 2),
    ((3, 5, 7, 16), torch.bfloat16, 3, 2),
    ((2, 3, 3, 300), torch.bfloat16, 4, 2),
    ((4, 8, 8, 3), torch.float32, 4, 2),
]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape,dtype,sm_count,blocks_per_sm", LANE_CASES)
def test_emulated_lanes_match_single_lane_launches(emu, emu_fwd, shape, dtype, sm_count,
                                                   blocks_per_sm, residual):
    """The lane-batched launches (lanes on blockIdx.z): L = 3 lane-major
    lanes, lane 1 with its own scale and shift, on the single-lane geometry
    the wrapper gives each lane.  Every lane's out, dy, dr, d_scale and
    d_shift are bitwise the single-lane launch on its slice (the same fold
    in the same order), for two block orders; every ticket is reset."""
    from fedml_tpu_torch.ops import fused_block as fb

    lanes, c = 3, shape[-1]
    rs = np.random.RandomState(sum(shape) + 3 * residual)
    y, r, g = (torch.from_numpy(rs.randn(lanes, *shape).astype(np.float32)).to(dtype)
               for _ in range(3))
    s = torch.from_numpy(rs.randn(c).astype(np.float32)).expand(lanes, c).contiguous()
    b = torch.from_numpy(rs.randn(c).astype(np.float32)).expand(lanes, c).contiguous()
    s[1], b[1] = s[1] * -3.0 + 0.5, b[1] + 1.0
    rows = y[0].numel() // c
    res = r if residual else None
    fgeo = fb.fwd_geometry(rows, c, dtype.itemsize, True, sm_count, blocks_per_sm)
    bgeo = fb.bwd_geometry(rows, c, dtype.itemsize, True, sm_count, blocks_per_sm)
    fargs = (ctypes.c_int * 9)(fb._DTYPE_CODES[dtype], *fgeo)
    bargs = (ctypes.c_int * 9)(fb._DTYPE_CODES[dtype], *bgeo)

    def ptr(t):
        return None if t is None else t.data_ptr()

    for seed in (1, 2):
        out = torch.full_like(y, float("nan"))
        assert emu_fwd.emu_fused_fwd_lanes(fargs, lanes, ptr(y), ptr(s), ptr(b), ptr(res),
                                           ptr(out), seed) == 0
        dy = torch.full_like(y, float("nan"))
        dr = torch.full_like(y, float("nan")) if residual else None
        dss = torch.full((lanes, 2, c), float("nan"))
        work = torch.full((lanes * bgeo.scratch_floats,), float("nan"))
        assert emu.emu_fused_bwd_lanes(bargs, lanes, ptr(g), ptr(y), ptr(s), ptr(out), ptr(dy),
                                       ptr(dr), ptr(dss), ptr(work), seed) == 0
        assert torch.equal(out, fb.fused_block_reference(y, s, b, res))
        for lane in range(lanes):
            one = torch.empty_like(y[lane])
            assert emu_fwd.emu_fused_fwd(fargs, ptr(y[lane]), ptr(s[lane]), ptr(b[lane]),
                                         None if res is None else ptr(res[lane]), ptr(one),
                                         seed) == 0
            assert torch.equal(one, out[lane])
            dy1, dss1 = torch.empty_like(dy[lane]), torch.empty((2, c))
            dr1 = torch.empty_like(dy[lane]) if residual else None
            work1 = torch.empty(bgeo.scratch_floats)
            assert emu.emu_fused_bwd(bargs, ptr(g[lane]), ptr(y[lane]), ptr(s[lane]), ptr(one),
                                     ptr(dy1), ptr(dr1), ptr(dss1), ptr(work1), seed) == 0
            assert torch.equal(dy1, dy[lane]) and torch.equal(dss1, dss[lane])
            assert not residual or torch.equal(dr1, dr[lane])
