"""Per-kernel timing of the port's kernel launches (``ops/timing.py``),
mirroring the reference's ``tests/test_pallas.py`` timing tests.

On the CPU each plain version runs through ``observe_eager`` and adds one
observation to its kernel's label in ``fedml_pallas_kernel_seconds`` (the
reference's family and labels); ``kernel_time_summary()`` has the
reference's shape.  The port observes every launch made outside CUDA-graph
capture, where the reference observes eager calls only and blocks on each
(a decided difference, ROADMAP Queue 3): the ``cuda``-marked case shows on
the card that a captured launch is not observed, that an eager launch is
observed without waiting for the card, that a launch with the observation
switched off takes no events, and that the observation count equals the
kernel's observed launches.  This file imports no JAX at
the top, so the ``cuda`` case runs on the card with ``--noconftest``; the
reference is imported inside the CPU tests.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

LABELS = ("fused_bn_relu", "fused_bn_residual_relu", "fused_bn_relu_bwd",
          "fused_bn_residual_relu_bwd", "quantize_int8_stochastic", "dequantize_int8",
          "apply_gaussian_noise")


def _calls(device):
    """One call of each wrapper, single-lane and lane-batched, on ``device``:
    ``[(label, thunk)]``."""
    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.ops import quantize as qz

    rs = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device)

    y, r, g = t(2, 4, 4, 16), t(2, 4, 4, 16), t(2, 4, 4, 16)
    s, b = t(16), t(16)
    ly, ls, lb = t(3, 2, 4, 4, 16), t(3, 16), t(3, 16)
    out = fb.fused_block_reference(y, s, b)
    vec = t(2048)
    u = torch.from_numpy(rs.rand(*qz.noise_shape(2048)).astype(np.float32)).to(device)
    lanes = t(3, 2048)
    lu = torch.from_numpy(rs.rand(3, *qz.noise_shape(2048)).astype(np.float32)).to(device)
    q = qz.quantize_int8_reference(vec, u)
    lq = qz.quantize_int8_lanes_reference(lanes, lu)
    draw = t(2048)
    return [
        ("fused_bn_relu", lambda: fb.fused_block_forward(y, s, b)),
        ("fused_bn_relu", lambda: fb.fused_block_forward(ly, ls, lb)),
        ("fused_bn_residual_relu", lambda: fb.fused_block_forward(y, s, b, r)),
        ("fused_bn_relu_bwd", lambda: fb.fused_block_backward(g, y, s, out, False)),
        ("fused_bn_residual_relu_bwd", lambda: fb.fused_block_backward(g, y, s, out, True)),
        ("quantize_int8_stochastic", lambda: qz.quantize_int8_stochastic(vec, u)),
        ("quantize_int8_stochastic", lambda: qz.quantize_int8_lanes(lanes, lu)),
        ("dequantize_int8", lambda: qz.dequantize_int8(*q)),
        ("dequantize_int8", lambda: qz.dequantize_int8_lanes(*lq)),
        ("apply_gaussian_noise", lambda: nz.apply_gaussian_noise(vec, draw, 0.5)),
    ]


@pytest.mark.parametrize("index", range(10))
def test_plain_version_call_adds_one_to_its_label(index):
    from fedml_tpu_torch.ops import timing

    label, call = _calls("cpu")[index]
    before = {k: timing.PALLAS_KERNEL_TIME.count(kernel=k) for k in LABELS}
    host_before = timing.host_observation_counts()
    call()
    after = {k: timing.PALLAS_KERNEL_TIME.count(kernel=k) for k in LABELS}
    host_after = timing.host_observation_counts()
    assert {k: after[k] - before[k] for k in LABELS} == {k: int(k == label) for k in LABELS}
    assert {k: host_after.get(k, 0) - host_before.get(k, 0) for k in LABELS} == {
        k: int(k == label) for k in LABELS}
    assert timing.PALLAS_KERNEL_TIME.sum(kernel=label) > 0


def test_observation_switched_off_times_no_call():
    """``set_observing(False)``: a plain version's call adds nothing to its
    label, and the switch reports the setting it replaced."""
    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.ops import timing

    y = torch.ones(2, 4, 4, 16)
    before = timing.PALLAS_KERNEL_TIME.count(kernel="fused_bn_relu")
    assert timing.set_observing(False) is True
    try:
        fb.fused_block_forward(y, torch.ones(16), torch.zeros(16))
    finally:
        assert timing.set_observing(True) is False
    assert timing.PALLAS_KERNEL_TIME.count(kernel="fused_bn_relu") == before
    fb.fused_block_forward(y, torch.ones(16), torch.zeros(16))
    assert timing.PALLAS_KERNEL_TIME.count(kernel="fused_bn_relu") == before + 1


def test_kernel_labels_are_the_references():
    """Each port kernel's label is the name the reference observes it under
    (its ``observe_eager`` call sites)."""
    import inspect

    from fedml_tpu.ops.pallas import fused_block as ref_fb
    from fedml_tpu.ops.pallas import noise as ref_nz
    from fedml_tpu.ops.pallas import quantize as ref_qz
    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.ops import quantize as qz

    ref_src = "".join(inspect.getsource(m) for m in (ref_fb, ref_nz, ref_qz))
    kernels = fb.KERNELS + fb.LANE_KERNELS + qz.KERNELS + qz.LANE_KERNELS + nz.KERNELS
    assert {k.label for k in kernels} == set(LABELS)
    for label in LABELS:
        assert f'"{label}"' in ref_src


def test_summary_render_and_sinks_have_the_references_shape():
    from fedml_tpu.ops.pallas import timing as ref_timing
    from fedml_tpu_torch.obs.registry import REGISTRY
    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.ops import timing

    seen = []
    sink = timing.add_sink(lambda name, s: seen.append((name, s)))
    try:
        y = torch.ones(2, 4, 4, 16)
        fb.fused_block_forward(y, torch.ones(16), torch.zeros(16))
    finally:
        timing.remove_sink(sink)
    timing.remove_sink(sink)  # a second removal is a no-op, as in the reference
    assert seen and seen[-1][0] == "fused_bn_relu" and seen[-1][1] > 0
    summary = timing.kernel_time_summary()
    assert summary["fused_bn_relu"]["count"] >= 1
    ref_summary = ref_timing.kernel_time_summary()
    for row in summary.values():
        assert set(row) == {"count", "total_s", "mean_s"}
        assert isinstance(row["count"], int)
    for row in ref_summary.values():
        assert set(row) == {"count", "total_s", "mean_s"}
    text = REGISTRY.render()
    assert "fedml_pallas_kernel_seconds_bucket" in text
    assert 'fedml_pallas_kernel_seconds_count{kernel="fused_bn_relu"}' in text
    assert ref_timing.PALLAS_KERNEL_TIME.name == timing.PALLAS_KERNEL_TIME.name
    assert ref_timing.PALLAS_KERNEL_TIME.help == timing.PALLAS_KERNEL_TIME.help
    assert ref_timing.PALLAS_KERNEL_TIME.buckets == timing.PALLAS_KERNEL_TIME.buckets


def test_cpu_launches_count_no_card_launch():
    """On the CPU the plain versions run: the kernels' launch counters stay
    untouched while their labels count."""
    from fedml_tpu_torch.ops import fused_block as fb

    before = fb.FWD.observed_launches, fb.FWD.launches
    fb.fused_block_forward(torch.ones(2, 4, 4, 16), torch.ones(16), torch.zeros(16))
    assert (fb.FWD.observed_launches, fb.FWD.launches) == before


def _fwd_args(device):
    return (torch.ones(2, 4, 4, 16, device=device), torch.ones(16, device=device),
            torch.zeros(16, device=device))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips without one (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_launches_observed_outside_capture_without_waiting(cuda_device):
    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.ops import quantize as qz
    from fedml_tpu_torch.ops import timing

    kernels = fb.KERNELS + fb.LANE_KERNELS + qz.KERNELS + qz.LANE_KERNELS + nz.KERNELS
    calls = _calls(cuda_device)
    for _label, call in calls:  # build and load every kernel
        call()
    timing.kernel_time_summary()
    base_obs = {k: timing.PALLAS_KERNEL_TIME.count(kernel=k) for k in LABELS}
    base_launch = {k.name: k.observed_launches for k in kernels}

    # an eager launch queued behind a long sleep returns before the card
    # reaches it: observed, pending, nothing waited for
    torch.cuda._sleep(int(2e8))
    label, call = calls[0]
    import time

    t0 = time.perf_counter()
    call()
    host_s = time.perf_counter() - t0
    assert timing.pending_count() >= 1
    assert host_s < 0.05, host_s

    # a launch with the observation off takes no events: launched, not
    # observed
    fwd_before = fb.FWD.launches
    timing.set_observing(False)
    try:
        fb.fused_block_forward(*_fwd_args(cuda_device))
    finally:
        timing.set_observing(True)
    assert fb.FWD.launches == fwd_before + 1

    # a captured launch is not observed (and not counted as observed)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            for _label, c in calls:
                c()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    summary = timing.kernel_time_summary()
    assert timing.pending_count() == 0
    obs = {k: timing.PALLAS_KERNEL_TIME.count(kernel=k) for k in LABELS}
    assert {k: obs[k] - base_obs[k] for k in LABELS} == {k: int(k == label) for k in LABELS}
    launched = {k.label: 0 for k in kernels}
    for k in kernels:
        launched[k.label] += k.observed_launches - base_launch[k.name]
    assert launched == {k: int(k == label) for k in LABELS}
    assert summary[label]["mean_s"] > 0
