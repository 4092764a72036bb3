"""The int8 quantize and dequantize kernels' own CUDA source, run on the CPU.

``tests/cuda_emu/`` emulates the CUDA features ``csrc/quantize.cu`` uses
(threads, warp shuffles, 16-byte vector types, the IEEE-rounded intrinsics)
on the host, and g++ builds the kernels' source against it with the
launches stripped.  Each kernel runs on the grid its C entry launches (the
source's own ``quantize_grid`` / ``dequantize_grid``) and in the variant
its wrapper would pick from the operands' alignment, its thread blocks one
after another in an order shuffled by a seed.  This holds both variants' indexing,
the ragged tail, the cross-warp max and the NaN / inf / zero blocks against
the plain versions before any card run, and the copies that
``obs/ablate_quant.py`` times likewise;
``tests/test_torch_cuda.py`` holds the built kernels on the card.

Tolerances: the int8 values, the scales and the dequantized vector bitwise
(a NaN as a NaN), for two block orders, the outputs poisoned differently
before each run so that an element left unwritten shows.
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
# 1 to 8 blocks and the flagship gradient's ragged tail (269,722 = 263 * 1024 + 410)
LENGTHS = [1, 3, 1023, 1024, 1025, 4098, 8 * 1024 + 410]
POISON = {1: 77, 2: -77}  # the int8 the values hold before the run of each seed


def _build(out: Path, src: str, harness: Path) -> ctypes.CDLL:
    """``src`` (a kernel source) with its launches stripped, as
    ``quantize_emu.cpp`` in ``out``, built with ``harness``."""
    src, n = re.subn(r"<<<[^>]*>>>", "", src)
    assert n >= 2, "a launch of each kernel"
    (out / "quantize_emu.cpp").write_text(src)
    lib = out / f"lib{harness.stem}.so"
    subprocess.run([shutil.which("g++"), "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-I", str(EMU), "-I", str(out), "-o", str(lib),
                    str(harness)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    for fn in ("emu_quantize", "emu_dequantize"):
        getattr(so, fn).restype = ctypes.c_int
    so.emu_quantize.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_uint]
    so.emu_dequantize.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_uint]
    if hasattr(so, "emu_geometry"):
        so.emu_geometry.restype = None
        so.emu_geometry.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
    return so


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernels built for the host emulation (once per module)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation of the kernels")
    src = (ROOT / "fedml_tpu_torch" / "csrc" / "quantize.cu").read_text()
    assert src.count("<<<") == 4, "two launches of each kernel"
    return _build(tmp_path_factory.mktemp("cuda_emu_quantize"), src, EMU / "emu_quantize.cpp")


def _at(t, misaligned: bool):
    """t, or a contiguous copy of it one element past a 16-byte line."""
    if not misaligned:
        return t
    base = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = base[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


def _assert_bitwise(got, want):
    """Equal bit for bit, a NaN as a NaN (its payload is the CPU's)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if not got.is_floating_point():
        assert torch.equal(got, want)
        return
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _quantize(emu, x, u):
    """The kernel's (values, scales) for each seed, in the variant the
    wrapper picks, and whether that is the vector one."""
    from fedml_tpu_torch.ops import build
    from fedml_tpu_torch.ops import quantize as qz

    n = x.numel()
    runs = []
    for seed, poison in POISON.items():
        values = _at(torch.full(qz.noise_shape(n), poison, dtype=torch.int8), x.data_ptr() % 16 != 0)
        scales = torch.full((values.shape[0],), -1.0)
        vec = build.aligned16((x.data_ptr(), u.data_ptr(), values.data_ptr()))
        assert emu.emu_quantize(x.data_ptr(), u.data_ptr(), values.data_ptr(), scales.data_ptr(), n,
                                vec, seed) == 0
        runs.append((values, scales))
    return runs, vec


def _dequantize(emu, values, scales, n):
    from fedml_tpu_torch.ops import build

    runs = []
    for seed, poison in POISON.items():
        out = torch.full((n,), float(poison) * 1e30)
        vec = build.aligned16((values.data_ptr(), out.data_ptr()))
        assert emu.emu_dequantize(values.data_ptr(), scales.data_ptr(), out.data_ptr(), n, vec,
                                  seed) == 0
        runs.append(out)
    return runs, vec


def _inputs(n, misaligned, seed):
    from fedml_tpu_torch.ops import quantize as qz

    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.randn(n) * np.exp(3 * rs.randn(n))).astype(np.float32))
    u = torch.from_numpy(rs.rand(*qz.noise_shape(n)).astype(np.float32))
    return _at(x, misaligned), _at(u, misaligned)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_quantize_matches_plain_version(emu, n, misaligned):
    """Values and scales bitwise the plain version's, for both variants (the
    scalar one on x, u and the values one element off a 16-byte line)."""
    from fedml_tpu_torch.ops import quantize as qz

    x, u = _inputs(n, misaligned, n % 1000 + misaligned)
    want = qz.quantize_int8_reference(x, u)
    runs, vec = _quantize(emu, x, u)
    assert vec == (not misaligned)
    for values, scales in runs:
        _assert_bitwise(values, want[0])
        _assert_bitwise(scales, want[1])


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_dequantize_matches_plain_version(emu, n, misaligned):
    """The dequantized vector bitwise the plain version's, for both variants
    (the scalar one on values one byte off a 16-byte line), the last partial
    group written element by element."""
    from fedml_tpu_torch.ops import quantize as qz

    x, u = _inputs(n, False, n % 1000 + 7)
    values, scales, _ = qz.quantize_int8_reference(x, u)
    values = _at(values, misaligned)
    want = qz.dequantize_int8_reference(values, scales, n)
    runs, vec = _dequantize(emu, values, scales, n)
    assert vec == (not misaligned)
    for out in runs:
        _assert_bitwise(out, want)


@pytest.mark.parametrize("n", [1025, 8 * 1024 + 410])
def test_emulated_lanes_match_single_lane_calls(emu, n):
    """The lane-batched form: 3 vectors, one scaled 1e6 apart, padded to
    whole blocks and laid end to end as ``quantize_int8_lanes`` lays them,
    one emulated launch of each kernel over all lanes; every lane's values,
    scales and dequantized vector bitwise its own single-lane launch."""
    from fedml_tpu_torch.ops import quantize as qz

    lanes = [_inputs(n, False, 40 + k) for k in range(3)]
    vecs = torch.stack([x * (1e6 if k == 1 else 1.0) for k, (x, _) in enumerate(lanes)])
    noise = torch.stack([u for _, u in lanes])
    x, u, shape = qz.lanes_end_to_end(vecs, noise)
    runs, vec = _quantize(emu, x, u)
    assert vec and x.numel() == 3 * shape[1] * 1024
    values, scales = runs[0][0].view(shape), runs[0][1].view(shape[:2])
    for other in runs[1:]:
        _assert_bitwise(other[0].view(shape), values)
    deq_runs, _ = _dequantize(emu, values.view((-1,) + shape[2:]), scales.view(-1), x.numel())
    deq = deq_runs[0].view(3, -1)[:, :n]
    for k in range(3):
        single, _ = _quantize(emu, vecs[k].contiguous(), noise[k].contiguous())
        _assert_bitwise(values[k], single[0][0])
        _assert_bitwise(scales[k], single[0][1])
        single_deq, _ = _dequantize(emu, single[0][0], single[0][1], n)
        _assert_bitwise(deq[k], single_deq[0])
    assert not torch.equal(scales[0], scales[1])  # the lanes' own scales


def _geometry(emu, kernel, n):
    """(grid, threads a block, values a block) of the C entry's launch."""
    geo = (ctypes.c_uint * 3)()
    emu.emu_geometry(("quantize", "dequantize").index(kernel), n, geo)
    return tuple(geo)


@pytest.mark.parametrize("kernel", ["quantize", "dequantize"])
@pytest.mark.parametrize("n", LENGTHS + [269722, 2**24, 2**24 + 410, 2**31 - 1])
def test_launch_geometry_covers_every_element_once(emu, n, kernel):
    """The C entry launches whole warps and just enough thread blocks for
    ``n`` elements (no block without work), up to lengths under 2^31: the
    unsigned index math does not wrap.  A quantization block is one thread
    block; a dequantize block's values are whole quantization blocks or
    divide one."""
    grid, threads, span = _geometry(emu, kernel, n)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert grid * span >= n > (grid - 1) * span
    assert span % 1024 == 0 or 1024 % span == 0
    assert kernel == "dequantize" or span == 1024


def test_launch_geometry_fills_the_card(emu):
    """On an H100's 132 SMs: the FedSGD gradient's 264 quantization blocks
    put 2 thread blocks on every SM, and its dequantize 264 blocks of 256
    threads; at 2^24 both launch more than one wave of the most threads an
    SM holds (2,048)."""
    assert _geometry(emu, "quantize", 269722)[:2] == (264, 256)
    assert _geometry(emu, "dequantize", 269722)[:2] == (264, 256)
    for kernel in ("quantize", "dequantize"):
        grid, threads, _ = _geometry(emu, kernel, 2**24)
        assert grid * threads >= 132 * 2048


def _special(n):
    """Blocks of: a NaN, +inf and -inf, zeros, -0.0; then ragged values."""
    rs = np.random.RandomState(5)
    x = (rs.randn(n) * 10).astype(np.float32)
    x[300] = np.nan
    x[1024 + 5], x[1024 + 900] = np.inf, -np.inf
    x[2048:3072] = 0.0
    x[3072:4096] = -0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("misaligned", [False, True])
def test_emulated_special_blocks_match_plain_version(emu, misaligned):
    """A NaN gives its block a NaN scale and the levels PyTorch's cast gives
    a NaN (0); +-inf an inf scale; zeros and -0.0 the scale 1e-12 and level
    0; both kernels and both variants bitwise the plain versions."""
    from fedml_tpu_torch.ops import quantize as qz

    n = 4 * 1024 + 410
    x = _at(_special(n), misaligned)
    u = _at(torch.from_numpy(np.random.RandomState(6).rand(*qz.noise_shape(n)).astype(np.float32)),
            misaligned)
    want = qz.quantize_int8_reference(x, u)
    assert want[1][0].isnan() and want[1][1].isinf() and float(want[1][2]) == float(
        np.float32(1e-12)) == float(want[1][3])
    assert int(want[0][0].abs().sum()) == 0 and int(want[0][2:4].abs().sum()) == 0
    runs, _ = _quantize(emu, x, u)
    for values, scales in runs:
        _assert_bitwise(values, want[0])
        _assert_bitwise(scales, want[1])
    values = _at(want[0], misaligned)
    outs, _ = _dequantize(emu, values, want[1], n)
    for out in outs:
        _assert_bitwise(out, qz.dequantize_int8_reference(values, want[1], n))


@pytest.mark.parametrize("copy", ["was", "u_late", "loads4", "ldg", "dq_ldcs", "plain_stores",
                                  "contig16", "t32", "t64", "t128", "dq2", "dq4", "dq_t64",
                                  "dq_t128"])
def test_emulated_ablation_copies_match_plain_version(tmp_path, copy):
    """Each copy ``obs/ablate_quant.py`` times on the card (the replaced
    design, and the kernels with one thing changed) builds against the
    emulation and equals the plain versions bitwise on the flagship's tail
    length, for two block orders."""
    from fedml_tpu_torch.obs import ablate_quant
    from fedml_tpu_torch.ops import quantize as qz

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation of the kernels")
    src = ablate_quant.variants((ROOT / "fedml_tpu_torch" / "csrc" / "quantize.cu").read_text())
    harness = "emu_quantize_was.cpp" if copy == "was" else "emu_quantize.cpp"
    so = _build(tmp_path, src[copy], EMU / harness)
    n = 8 * 1024 + 410
    x, u = _inputs(n, False, 11)
    want = qz.quantize_int8_reference(x, u)
    for seed, poison in POISON.items():
        values = torch.full(qz.noise_shape(n), poison, dtype=torch.int8)
        scales = torch.full((values.shape[0],), -1.0)
        assert so.emu_quantize(x.data_ptr(), u.data_ptr(), values.data_ptr(), scales.data_ptr(), n,
                               1, seed) == 0
        _assert_bitwise(values, want[0])
        _assert_bitwise(scales, want[1])
        out = torch.full((n,), float(poison) * 1e30)
        assert so.emu_dequantize(want[0].data_ptr(), want[1].data_ptr(), out.data_ptr(), n, 1,
                                 seed) == 0
        _assert_bitwise(out, qz.dequantize_int8_reference(want[0], want[1], n))
