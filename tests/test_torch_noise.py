"""Port parity: the Gaussian noise op (``fedml_tpu_torch/ops/noise.py``)
against ``fedml_tpu/ops/pallas/noise.py``, and the thread safety of the
kernels' bookkeeping (``ops/build.py``).

The same vector (numpy, seeded) and the reference's own N(0, 1) draw
(``jax.random.normal(key, (blocks, 8, 128))``, or its first n values flat)
go through both packages.

Tolerances: the port's plain version is bitwise equal to the reference's
eager oracle ``apply_gaussian_noise_reference`` (both round the multiply,
then the add).  Against the Pallas kernel in interpret mode: bitwise at
sigma = 0.25 (every product exact), within one f32 ulp at the DP sigma,
where XLA:CPU contracts ``x + noise * sigma`` into an FMA.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

LENGTHS = [1, 1023, 1024, 1025, 2500, 269722]


def _dp_sigma():
    from fedml_tpu.trust.dp.dp import gaussian_sigma

    return gaussian_sigma(50.0, 1e-5, 0.01)


def _inputs(n, seed=0):
    from fedml_tpu_torch.ops import noise as nz

    x = np.random.default_rng(seed).normal(0, 1, n).astype(np.float32)
    key = jax.random.PRNGKey(seed + 7)
    draw = np.asarray(jax.random.normal(key, nz.noise_shape(n), jnp.float32))
    return x, key, draw


def _ulps(a, b, product):
    """Distance in f32 ulps of the larger of |b| and |product|: rounding
    the product once more moves the sum by at most half an ulp of the
    product, and the sum's own rounding by half an ulp of the sum."""
    scale = np.maximum(np.abs(b), np.abs(product)).astype(np.float32)
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / np.spacing(scale).astype(
        np.float64)


@pytest.mark.parametrize("sigma", ["quarter", "dp"])
@pytest.mark.parametrize("n", LENGTHS)
def test_plain_version_bitwise_equals_eager_oracle(n, sigma):
    from fedml_tpu.ops.pallas import noise as ref
    from fedml_tpu_torch.ops import noise as nz

    s = 0.25 if sigma == "quarter" else _dp_sigma()
    x, key, draw = _inputs(n)
    want = np.asarray(ref.apply_gaussian_noise_reference(jnp.asarray(x), key, s))
    got = nz.apply_gaussian_noise(torch.from_numpy(x), torch.from_numpy(draw), s)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the eager oracle is numpy's two roundings: f32(x + f32(noise * sigma))
    two = x + (draw.reshape(-1)[:n] * np.float32(s)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), two)


@pytest.mark.parametrize("n", [1025, 269722])
def test_plain_version_against_interpret_kernel(n):
    """Bitwise at sigma 0.25; within one ulp at the DP sigma (the interpret
    kernel's FMA rounds once where the written order rounds twice)."""
    from fedml_tpu.ops.pallas import noise as ref
    from fedml_tpu_torch.ops import noise as nz

    x, key, draw = _inputs(n, seed=3)
    for s, max_ulps in ((0.25, 0.0), (_dp_sigma(), 1.0)):
        want = np.asarray(ref.apply_gaussian_noise(jnp.asarray(x), key, s, interpret=True))
        got = nz.apply_gaussian_noise(torch.from_numpy(x), torch.from_numpy(draw), s).numpy()
        product = draw.reshape(-1)[:n].astype(np.float64) * np.float32(s)
        assert _ulps(got, want, product).max() <= max_ulps, s
        if max_ulps == 0.0:
            np.testing.assert_array_equal(got, want)


def test_sigma_zero_is_identity_and_wrong_inputs_raise():
    from fedml_tpu_torch.ops import noise as nz

    x, _, draw = _inputs(2500)
    xt, nt = torch.from_numpy(x), torch.from_numpy(draw)
    assert torch.equal(nz.apply_gaussian_noise(xt, nt, 0.0), xt)
    with pytest.raises(ValueError, match="noise must be"):
        nz.apply_gaussian_noise(xt, nt[:-1], 0.1)
    with pytest.raises(ValueError, match="noise must be"):
        nz.apply_gaussian_noise(xt, nt.double(), 0.1)
    with pytest.raises(ValueError, match="flat vector"):
        nz.apply_gaussian_noise(xt.reshape(50, 50), nt, 0.1)
    assert nz.noise_shape(1) == (1, 8, 128) and nz.noise_shape(1025) == (2, 8, 128)
    assert nz.launch_counts() == {"gaussian_noise": 0}  # CPU: the plain version


@pytest.mark.parametrize("n", [1, 1025, 2500, 8 * 271])
def test_flat_draw_equals_padded_draw(n):
    """The op takes the N(0, 1) draw flat ``(n,)`` too (local DP's m client
    draws laid end to end): bitwise the padded draw's result when the first
    ``n`` values agree, and the reference's eager oracle; a flat draw of
    another length or a strided one raises."""
    from fedml_tpu.ops.pallas import noise as ref
    from fedml_tpu_torch.ops import noise as nz

    x, key, draw = _inputs(n, seed=1)
    flat = torch.from_numpy(draw.reshape(-1)[:n].copy())
    padded = nz.apply_gaussian_noise(torch.from_numpy(x), torch.from_numpy(draw), _dp_sigma())
    got = nz.apply_gaussian_noise(torch.from_numpy(x), flat, _dp_sigma())
    assert torch.equal(got, padded)
    want = np.asarray(ref.apply_gaussian_noise_reference(jnp.asarray(x), key, _dp_sigma()))
    np.testing.assert_array_equal(got.numpy(), want)
    strided = [torch.zeros(n, 2)[:, 0]] if n > 1 else []  # one element is contiguous
    for bad in [torch.zeros(n + 1)] + strided:
        with pytest.raises(ValueError, match="noise must be"):
            nz.apply_gaussian_noise(torch.from_numpy(x), bad, 0.5)


def test_launch_counts_exact_under_threads():
    """``Kernel.count_launch`` from 8 threads at once, with the interpreter
    switching threads every microsecond, loses no count."""
    from fedml_tpu_torch.ops import build

    k = build.Kernel("probe", "nowhere:0")
    barrier = threading.Barrier(8)

    def hammer():
        barrier.wait()
        for _ in range(20000):
            k.count_launch()

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert k.launches == 8 * 20000
    k.reset()
    assert k.launches == 0


def test_load_library_builds_once_under_threads(monkeypatch, tmp_path):
    """Eight threads that first use a kernel together run one build and get
    one library."""
    from fedml_tpu_torch.ops import build

    calls, loaded = [], []
    lib_path = tmp_path / "noise.so"

    def fake_build(names):
        calls.append(threading.get_ident())
        threading.Event().wait(0.05)  # a slow nvcc: the others arrive meanwhile
        lib_path.write_bytes(b"")
        return {}

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)
            self.gaussian_noise = type("Fn", (), {})()

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build, "library_path", lambda name: lib_path)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(build, "_LOADED", {})
    barrier = threading.Barrier(8)
    got = []

    def first_use():
        barrier.wait()
        got.append(build.load_library("noise", {"gaussian_noise": (None, [])}))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(loaded) == 1
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_build_names_its_temporary_file_by_process_and_thread(monkeypatch, tmp_path):
    """nvcc writes to a file named by pid and thread, then the library is
    renamed into place (no nvcc here: a fake process writes the file)."""
    import os

    from fedml_tpu_torch.ops import build

    outputs = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            outputs.append(out)
            open(out, "wb").close()

        def communicate(self):
            return "ptxas info", None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "library_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    idents = []

    def first_build():
        idents.append(threading.get_ident())
        build.build(["noise"])

    t = threading.Thread(target=first_build)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert outputs == [str(tmp_path / f"libnoise.{os.getpid()}.{idents[0]}.tmp")]
    assert (tmp_path / "libnoise.so").exists() and not os.path.exists(outputs[0])
