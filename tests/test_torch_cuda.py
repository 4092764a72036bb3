"""The port's kernels on the card (marker ``cuda``; skipped without one).

This file imports only torch and the port, so it also runs on the machine
with the card, where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: f32 forward and dy / dr bitwise against the plain versions, bf16
to one bf16 ulp (the same f32 math and rounding), d_scale / d_shift to rtol
1e-5 / atol 1e-4 (f32 sums of up to ~10k terms in another order); the fused
ResNet step on the card against the CPU to rtol 1e-3 / atol 1e-4 (cuDNN and
CPU convolutions, TF32 off).  The int8 quantize / dequantize kernels:
values, scales and the dequantized vector bitwise against the plain
versions on the card and on the CPU (IEEE divides, order-free max).  The
central-DP noise kernel: bitwise against its plain version on the card and
on the CPU (the multiply, then the add, each rounded).  A Shamir SecAgg
finalize on the card against the CPU: bitwise without DP; with central DP
the clip's norm sums in another order, so one ulp plus 1e-5 of the clipped
delta's largest element (two ulps after the noise).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips without one.  Decided at run time, so
    every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(shape, dtype, device, seed=7):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    y, r, g = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device, dtype)
               for _ in range(3))
    s, b = (torch.from_numpy(rs.randn(c).astype(np.float32)).to(device) for _ in range(2))
    return y, r, g, s, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 32, 16), (4, 7, 9, 24), (8, 8, 8, 64), (2, 3, 3, 300)])
def test_kernels_match_plain_versions(shape, dtype, cuda_device):
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs(shape, dtype, cuda_device)
    ulp = 0.0 if dtype == torch.float32 else 2.0 ** -8
    for residual in (None, r):
        before = fb.launch_counts()
        out = fb.fused_block_forward(y, s, b, residual)
        torch.testing.assert_close(out, fb.fused_block_reference(y, s, b, residual),
                                   rtol=ulp, atol=0)
        got = fb.fused_block_backward(g, y, s, out, residual is not None)
        want = fb.fused_block_bwd_reference(g, y, s, out, residual is not None)
        torch.testing.assert_close(got[0], want[0], rtol=ulp, atol=0)
        if residual is not None:
            torch.testing.assert_close(got[3], want[3], rtol=ulp, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-4)
        after = fb.launch_counts()
        fwd, bwd = (fb.FWD_RES, fb.BWD_RES) if residual is not None else (fb.FWD, fb.BWD)
        assert after[fwd.name] == before[fwd.name] + 1
        assert after[bwd.name] == before[bwd.name] + 1


@pytest.mark.cuda
def test_backward_reduction_is_deterministic(cuda_device):
    """No atomics: the same inputs give bitwise the same d_scale / d_shift."""
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs((64, 16, 16, 32), torch.bfloat16, cuda_device)
    out = fb.fused_block_forward(y, s, b, r)
    first = fb.fused_block_backward(g, y, s, out, True)
    for _ in range(3):
        again = fb.fused_block_backward(g, y, s, out, True)
        for a, e in zip(again, first):
            assert torch.equal(a, e)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_and_wrong_dtype(cuda_device):
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs((2, 4, 4, 16), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        fb.fused_block_forward(y.permute(0, 3, 1, 2), s, b)
    with pytest.raises(TypeError):
        fb.fused_block_forward(y.half(), s, b)
    with pytest.raises(ValueError):
        fb.fused_block_forward(y, s.cpu(), b)


@pytest.mark.cuda
def test_fused_resnet_step_card_matches_cpu(cuda_device):
    """A fused resnet20 train step (f32) on the card equals the same step on
    the CPU: logits, grads and new batch stats."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import resnet

    model = resnet.resnet20(10, torch.float32, fused=True)
    gen = torch.Generator().manual_seed(0)
    variables = model.init(gen)
    x = torch.randn((4, 32, 32, 3), generator=gen)
    outs = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev, copy=True).requires_grad_(True)
                  for t in pt.tree_leaves(variables["params"])]
        params = pt.tree_unflatten_like(variables["params"], leaves)
        stats = pt.tree_map(lambda t: t.to(dev), variables["batch_stats"])
        logits, new_stats = model.apply({"params": params, "batch_stats": stats}, x.to(dev), True)
        grads = torch.autograd.grad((logits - 1.0).square().mean(), leaves)
        outs[str(dev)] = [t.detach().cpu() for t in [logits, *grads, *pt.tree_leaves(new_stats)]]
    for a, b in zip(outs["cpu"], outs[str(cuda_device)]):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 5000, 269722, 2**20 + 3])
def test_quantize_kernels_match_plain_versions(n, cuda_device):
    from fedml_tpu_torch.ops import quantize as qz

    rs = np.random.RandomState(n % 1000)
    x = (rs.randn(n) * np.exp(3 * rs.randn(n))).astype(np.float32)
    u = rs.rand(*qz.noise_shape(n)).astype(np.float32)
    xd, ud = torch.from_numpy(x).to(cuda_device), torch.from_numpy(u).to(cuda_device)
    before = qz.launch_counts()
    values, scales, length = qz.quantize_int8_stochastic(xd, ud)
    want = qz.quantize_int8_reference(xd, ud)
    cpu = qz.quantize_int8_reference(torch.from_numpy(x), torch.from_numpy(u))
    assert length == n and values.dtype == torch.int8 and values.shape == want[0].shape
    for got, ref in ((values, want[0]), (scales, want[1])):
        assert torch.equal(got, ref)
    assert torch.equal(values.cpu(), cpu[0]) and torch.equal(scales.cpu(), cpu[1])
    out = qz.dequantize_int8(values, scales, length)
    assert out.shape == (n,)
    assert torch.equal(out, qz.dequantize_int8_reference(values, scales, length))
    assert torch.equal(out.cpu(), qz.dequantize_int8_reference(cpu[0], cpu[1], n))
    after = qz.launch_counts()
    assert after[qz.QUANTIZE.name] == before[qz.QUANTIZE.name] + 1
    assert after[qz.DEQUANTIZE.name] == before[qz.DEQUANTIZE.name] + 1


@pytest.mark.cuda
def test_quantize_kernel_rejects_bad_operands(cuda_device):
    from fedml_tpu_torch.ops import quantize as qz

    x = torch.randn(3000, device=cuda_device)
    u = torch.rand(qz.noise_shape(3000), device=cuda_device)
    with pytest.raises(ValueError, match="noise must be"):
        qz.quantize_int8_stochastic(x, u[:2])
    with pytest.raises(ValueError, match="noise must be"):
        qz.quantize_int8_stochastic(x, u.double())
    with pytest.raises(ValueError):
        qz.quantize_int8_stochastic(x, u.cpu())
    with pytest.raises(ValueError, match="flat vector"):
        qz.quantize_int8_stochastic(x[:0], u[:0])
    values, scales, n = qz.quantize_int8_stochastic(x, u)
    with pytest.raises(ValueError):
        qz.dequantize_int8(values, scales[:2], n)
    with pytest.raises(ValueError):
        qz.dequantize_int8(values, scales, 5000)


@pytest.mark.cuda
def test_fedsgd_qsgd_int8_round_launches_the_kernels(cuda_device, tmp_path):
    """A tiny FedSGD qsgd_int8 run on the card: one quantize and one
    dequantize launch per client per round, finite metrics."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.ops import quantize as qz
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(Config(
        dataset="cifar10", model="resnet20", client_num_in_total=4, client_num_per_round=4,
        comm_round=2, batch_size=8, synthetic_train_size=64, synthetic_test_size=40,
        partition_method="homo", federated_optimizer="FedSGD", compression="qsgd_int8",
        frequency_of_the_test=2, compute_dtype="bfloat16", data_cache_dir=str(tmp_path)))
    runner = FedMLRunner(cfg, device=cuda_device)
    qz.reset_launch_counts()
    hist = runner.run()
    assert qz.launch_counts() == {qz.QUANTIZE.name: 8, qz.DEQUANTIZE.name: 8}
    assert np.isfinite(hist[-1]["test_loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 4097, 271098, 2**20 + 3])
def test_noise_kernel_matches_plain_version(n, cuda_device):
    """Bitwise at the slice's DP sigma and at 0.25; sigma 0 is the identity;
    one launch per call."""
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.trust.dp.dp import gaussian_sigma

    rs = np.random.RandomState(n % 997)
    x = torch.from_numpy(rs.randn(n).astype(np.float32)).to(cuda_device)
    noise = torch.from_numpy(rs.randn(*nz.noise_shape(n)).astype(np.float32)).to(cuda_device)
    for sigma in (gaussian_sigma(50.0, 1e-5, 0.01), 0.25):
        before = nz.launch_counts()[nz.NOISE.name]
        out = nz.apply_gaussian_noise(x, noise, sigma)
        assert nz.launch_counts()[nz.NOISE.name] == before + 1
        assert out.shape == (n,) and out.device == x.device
        assert torch.equal(out, nz.apply_gaussian_noise_reference(x, noise, sigma))
        assert torch.equal(out.cpu(), nz.apply_gaussian_noise_reference(x.cpu(), noise.cpu(),
                                                                        sigma))
    assert torch.equal(nz.apply_gaussian_noise(x, noise, 0.0), x)


@pytest.mark.cuda
def test_noise_kernel_rejects_bad_operands(cuda_device):
    from fedml_tpu_torch.ops import noise as nz

    x = torch.randn(3000, device=cuda_device)
    noise = torch.randn(nz.noise_shape(3000), device=cuda_device)
    with pytest.raises(ValueError, match="noise must be"):
        nz.apply_gaussian_noise(x, noise[:2], 0.1)
    with pytest.raises(ValueError, match="noise must be"):
        nz.apply_gaussian_noise(x, noise.double(), 0.1)
    with pytest.raises(ValueError, match="noise on"):
        nz.apply_gaussian_noise(x, noise.cpu(), 0.1)
    with pytest.raises(ValueError, match="flat vector"):
        nz.apply_gaussian_noise(x[:0], noise[:0], 0.1)


class _FixedNoise:
    """The same N(0, 1) draw for every device (made with numpy)."""

    def __init__(self):
        self.calls = 0

    def gaussian(self, round_idx, shape, device):
        self.calls += 1
        rs = np.random.RandomState(1000 + round_idx)
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device)


def _secagg_finalize(device, dp: bool):
    """One streamed Shamir SecAgg round of 4 silos (client 4 drops out
    before its upload) finalized by ``SAAggregator`` on ``device``; returns
    ``(new global flat, clipped global flat or None)`` on the CPU."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.cross_silo import secagg_shamir as sa
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.trust.secagg.shamir import shamir_share

    p = 2**31 - 1
    kw = dict(enable_dp=True, dp_solution_type="cdp", epsilon=50.0, delta=1e-5,
              sensitivity=0.01, clipping_norm=1.0) if dp else {}
    cfg = Config(dataset="cifar10", model="resnet20", client_num_in_total=4,
                 client_num_per_round=4, training_type="cross_silo", enable_secagg=True,
                 extra={"secagg_method": "shamir", "secagg_stream": True,
                        "secagg_privacy_t": 2}, **kw)
    model = resnet.resnet20(10)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    test = (np.zeros((32, 32, 32, 3), np.float32), np.zeros(32, np.int64), 32)
    agg = sa.SAAggregator(cfg, model, test, device, global_vars=init, noise_sampler=_FixedNoise())
    base = weights.flatten_reference(init)[0].numpy()
    rs = np.random.RandomState(3)
    s_sk = {u: int(rs.randint(2, p - 1)) for u in (1, 2, 3, 4)}
    agg.s_pk_table = {u: pow(sa.DH_G, k, p) for u, k in s_sk.items()}
    b = {u: int(rs.randint(0, 2**31)) for u in (1, 2, 3, 4)}
    b_sh = {u: shamir_share(b[u], 4, 3, rs) for u in b}
    sk_sh = {u: shamir_share(s_sk[u], 4, 3, rs) for u in b}
    survivors = (1, 2, 3)
    for u in survivors:
        flat = (base + rs.normal(0, 0.01, base.size)).astype(np.float32)
        peers = {v: sa.derive_round_seed(sa.dh_agree(s_sk[u], agg.s_pk_table[v]), 0)
                 for v in b if v != u}
        packed, meta = sa.mask_upload(flat, u, peers, sa.derive_round_seed(b[u], 0), 16, agg.ring)
        agg.add_masked_upload(u, packed, 1.0, meta)
    for v in survivors:
        agg.add_reveal(v, {str(u): b_sh[u][v - 1][1] for u in survivors},
                       {"4": sk_sh[4][v - 1][1]})
    agg.aggregate(0)
    assert agg.noise_sampler.calls == int(dp) and 4 in agg.compromised
    pre = agg.dp_pre_noise.cpu().numpy() if dp else None
    return weights.flatten_reference(agg.global_vars)[0].cpu().numpy(), pre, base


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [False, True])
def test_secagg_finalize_card_matches_cpu(dp, cuda_device):
    """The same uploads and reveals finalized on the card and on the CPU:
    without DP bitwise (the field math is the host's, the mean is copied to
    the device once); with central DP the clip's norm sums in another order
    on the card: within one ulp plus 1e-5 of the clipped delta's largest
    element, then the noise kernel adds one more rounding of the same
    operands (two ulps)."""
    from fedml_tpu_torch.ops import noise as nz

    before = nz.launch_counts()[nz.NOISE.name]
    got, pre_card, base = _secagg_finalize(cuda_device, dp)
    assert nz.launch_counts()[nz.NOISE.name] == before + int(dp)
    want, pre_cpu, _ = _secagg_finalize("cpu", dp)
    if not dp:
        assert np.array_equal(got, want)
        return
    scale = np.abs(pre_cpu - base).max()
    assert np.linalg.norm((pre_cpu - base).astype(np.float64)) == pytest.approx(1.0, rel=1e-4)
    assert (np.abs(pre_card - pre_cpu) <= np.spacing(np.abs(pre_cpu)) + 1e-5 * scale).all()
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want)) + 1e-5 * scale).all()
    assert not np.array_equal(got, pre_card)
