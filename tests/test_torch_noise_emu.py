"""The central-DP noise kernel's own CUDA source, run on the CPU.

``tests/cuda_emu/`` emulates the CUDA features ``csrc/noise.cu`` uses
(threads, 16-byte vector types, evict-first loads and stores, the
IEEE-rounded intrinsics) on the host, and g++ builds the kernel's source against it with
the launches stripped.  The kernel runs on the grid its C entry launches
(the source's own ``noise_grid``) and in the variant its wrapper would pick
from the operands' alignment, its thread blocks one after another in an
order shuffled by a seed.  This holds both variants' indexing, the tiles
that hold the end of the vector and the group that straddles it, sigma 0
and NaN / inf / -0 elements against the plain version before any card run,
and the copies that ``obs/ablate_noise.py`` times likewise;
``tests/test_torch_cuda.py`` holds the built kernel on the card.

Tolerance: bitwise (a NaN as a NaN), for two block orders, the output
poisoned differently before each run so that an element left unwritten
shows.
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
SOURCE = ROOT / "fedml_tpu_torch" / "csrc" / "noise.cu"
# 1 to 5 float4 groups, 1 to 5 draw blocks, and a vector with the SecAgg
# vector's tail (271,098 = 264 * 1024 + 762; n % 4 = 2)
LENGTHS = [1, 3, 4, 5, 1023, 1024, 1025, 4098, 4 * 1024 + 762]
POISON = {1: 7e30, 2: -7e30}  # the value out holds before the run of each seed
DP_SIGMA = 0.000968961  # the cross-silo path's (epsilon 50, delta 1e-5, sensitivity 0.01)


def _build(out: Path, src: str, harness: Path) -> ctypes.CDLL:
    """``src`` (a kernel source) with its launches stripped, as
    ``noise_emu.cpp`` in ``out``, built with ``harness``."""
    src, n = re.subn(r"<<<[^>]*>>>", "", src)
    assert n >= 1, "a launch of the kernel"
    (out / "noise_emu.cpp").write_text(src)
    lib = out / f"lib{harness.stem}.so"
    subprocess.run([shutil.which("g++"), "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-I", str(EMU), "-I", str(out), "-o", str(lib),
                    str(harness)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.emu_noise.restype = ctypes.c_int
    so.emu_noise.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_uint]
    if hasattr(so, "emu_geometry"):
        so.emu_geometry.restype = None
        so.emu_geometry.argtypes = [ctypes.c_uint, ctypes.c_void_p]
    return so


def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation of the kernel")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernel built for the host emulation (once per module)."""
    _needs_gxx()
    src = SOURCE.read_text()
    assert src.count("<<<") == 1, "one launch, of the variant's instance"
    return _build(tmp_path_factory.mktemp("cuda_emu_noise"), src, EMU / "emu_noise.cpp")


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
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _noise(so, x, noise, sigma, misaligned=False, vec=None):
    """The kernel's output for each seed (out poisoned first, off a 16-byte
    line with x when ``misaligned``), in the variant the wrapper picks, and
    whether that is the vector one."""
    from fedml_tpu_torch.ops import build

    n = x.numel()
    runs = []
    for seed, poison in POISON.items():
        out = _at(torch.full((n,), poison), misaligned)
        picked = build.aligned16((x.data_ptr(), noise.data_ptr(), out.data_ptr()))
        assert so.emu_noise(x.data_ptr(), noise.data_ptr(), sigma, out.data_ptr(), n,
                            picked if vec is None else vec, seed) == 0
        runs.append(out)
    return runs, picked


def _inputs(n, misaligned, seed):
    from fedml_tpu_torch.ops import noise as nz

    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.randn(n) * np.exp(3 * rs.randn(n))).astype(np.float32))
    noise = torch.from_numpy(rs.randn(*nz.noise_shape(n)).astype(np.float32))
    return _at(x, misaligned), noise


@pytest.mark.parametrize("sigma", [DP_SIGMA, 0.25])
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_noise_matches_plain_version(emu, n, misaligned, sigma):
    """Bitwise the plain version's, for both variants (the scalar one on x
    and out one element off a 16-byte line)."""
    from fedml_tpu_torch.ops import noise as nz

    x, noise = _inputs(n, misaligned, n % 1000 + misaligned)
    want = nz.apply_gaussian_noise_reference(x, noise, sigma)
    runs, vec = _noise(emu, x, noise, sigma, misaligned)
    assert vec == (not misaligned)
    for out in runs:
        _assert_bitwise(out, want)


@pytest.mark.parametrize("misaligned", [False, True])
def test_emulated_noise_at_sigma_zero_is_the_identity(emu, misaligned):
    """sigma 0: out equals x (-0 + 0 * noise as IEEE gives it) and the plain
    version bitwise."""
    from fedml_tpu_torch.ops import noise as nz

    n = 4 * 1024 + 762
    x, noise = _inputs(n, misaligned, 3)
    runs, _ = _noise(emu, x, noise, 0.0, misaligned)
    for out in runs:
        assert torch.equal(out, x)
        _assert_bitwise(out, nz.apply_gaussian_noise_reference(x, noise, 0.0))


@pytest.mark.parametrize("sigma", [DP_SIGMA, 0.0])
@pytest.mark.parametrize("misaligned", [False, True])
def test_emulated_special_values_match_plain_version(emu, misaligned, sigma):
    """NaN, +-inf and -0.0 in x (a NaN stays a NaN, an inf an inf, -0 + 0 *
    noise takes the sign IEEE gives it), in whole groups and in the group
    that straddles the end: both variants bitwise the plain version."""
    from fedml_tpu_torch.ops import noise as nz

    n = 2 * 1024 + 762
    rs = np.random.RandomState(5)
    x = rs.randn(n).astype(np.float32)
    x[[0, 300, n - 1]] = np.nan
    x[[5, 1024 + 900]] = np.inf
    x[[6, n - 2]] = -np.inf
    x[2048:2100] = -0.0
    x[[7, n - 3]] = -0.0
    x = _at(torch.from_numpy(x), misaligned)
    noise = torch.from_numpy(rs.randn(*nz.noise_shape(n)).astype(np.float32))
    want = nz.apply_gaussian_noise_reference(x, noise, sigma)
    assert want.isnan().sum() == 3 and want.isinf().sum() == 4
    runs, _ = _noise(emu, x, noise, sigma, misaligned)
    for out in runs:
        _assert_bitwise(out, want)


def test_emulated_scalar_variant_on_aligned_operands(emu):
    """The scalar variant also runs on 16-byte aligned operands (the entry
    takes either), bitwise."""
    from fedml_tpu_torch.ops import noise as nz

    n = 4 * 1024 + 762
    x, noise = _inputs(n, False, 9)
    runs, vec = _noise(emu, x, noise, DP_SIGMA, vec=0)
    assert vec
    for out in runs:
        _assert_bitwise(out, nz.apply_gaussian_noise_reference(x, noise, DP_SIGMA))


def _geometry(emu, n):
    """(grid, threads a block, elements a tile) of the C entry's launch."""
    geo = (ctypes.c_uint * 3)()
    emu.emu_geometry(n, geo)
    return tuple(geo)


@pytest.mark.parametrize("n", LENGTHS + [271098, 2**24, 2**24 + 6, 2**31 - 1])
def test_launch_geometry_covers_every_element_once(emu, n):
    """The C entry launches whole warps and one thread block a tile of
    float4 groups (no block without work), up to lengths under 2^31: the
    unsigned index math does not wrap."""
    grid, threads, tile = _geometry(emu, n)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert tile % (4 * threads) == 0 and tile // (4 * threads) in (1, 2, 4)
    assert grid * tile >= n > (grid - 1) * tile
    assert (grid * tile) < 2**32


def test_launch_geometry_at_the_secagg_vector(emu):
    """At 271,098 elements on an H100's 132 SMs the launch puts every
    thread block in one resident wave (at most 8 blocks of 256 threads an
    SM): one round trip to device memory; at 2^24 it launches more than a
    wave of the most threads an SM holds (2,048)."""
    grid, threads, _ = _geometry(emu, 271098)
    assert grid * threads <= 132 * 2048
    grid, threads, _ = _geometry(emu, 2**24)
    assert grid * threads >= 132 * 2048


def _copies():
    from fedml_tpu_torch.obs import ablate_noise

    return ablate_noise.variants(SOURCE.read_text())


@pytest.mark.parametrize("n", [1025, 4 * 1024 + 762])
@pytest.mark.parametrize("copy", ["was", "k1", "k4", "wave", "loads4", "ldg", "ld",
                                  "plain_stores"])
def test_emulated_ablation_copies_match_plain_version(tmp_path, copy, n):
    """Each copy ``obs/ablate_noise.py`` times on the card (the replaced
    kernel, and the kernel with one thing changed; ``wave`` on an
    emulated card of 2 SMs, so its grid walks several tiles a block)
    builds against the emulation and equals the plain version bitwise, at
    a length one past a draw block and at the SecAgg vector's tail, for two
    block orders."""
    from fedml_tpu_torch.ops import noise as nz

    _needs_gxx()
    copies = _copies()
    harness = "emu_noise_was.cpp" if copy == "was" else "emu_noise.cpp"
    so = _build(tmp_path, copies[copy], EMU / harness)
    x, noise = _inputs(n, False, 11)
    runs, _ = _noise(so, x, noise, DP_SIGMA)
    for out in runs:
        _assert_bitwise(out, nz.apply_gaussian_noise_reference(x, noise, DP_SIGMA))


def test_ablation_copies_change_one_thing():
    """``obs/ablate_noise.py`` finds each place it patches: every copy but
    the replaced kernel differs from the source, and the names are the
    source's complements."""
    copies = _copies()
    src = SOURCE.read_text()
    assert copies["final"] == src and "was" in copies
    assert set(copies) == {"final", "was", "k1", "k4", "wave", "loads4", "ldg", "ld",
                           "plain_stores"}
    for name, text in copies.items():
        if name not in ("final", "was"):
            assert text != src, name
