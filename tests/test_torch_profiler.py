"""The profile window and the cost-model gauges of the port
(``obs/profiler.py``, ``ops/flops.py``, ``sim/engine.py``) against the
reference's.

- ``parse_profile_rounds``, ``split_time_buckets`` and ``bucket_rows`` are
  host code: equal outputs on the same inputs (generated strings for the
  parser), but for the one decided difference, ``memcpy`` counted as h2d.
- A CPU window around a tiny MESH round writes an attribution JSON with
  the reference's keys, and its buckets sum to the window's wall time.
- The FLOP count (``FlopCounterMode``, matmuls and convolutions, every
  local step) against the reference's XLA cost model on the same round
  (logistic regression, 2 clients of 2 local steps of 8 rows).  XLA counts
  the local-step loop's body once and elementwise work too, and on the
  suite's 8-device CPU mesh (``tests/conftest.py``) its figure is one
  device's share of the sharded round program: 27,091 FLOPs here, 51,680
  on one device, against the port's 76,800.  Measured before the figure
  was set; the ratio ``FLOP_RATIO`` is held to 1e-6.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from hypothesis import given, settings, strategies as st

torch.set_num_threads(1)

FLOP_RATIO = 76800 / 27091
#: the keys of the reference's attribution JSON (its ``_attribute``)
ATTRIBUTION_KEYS = ("window", "buckets", "by_category", "by_source", "programs",
                    "cost_model_flops", "trace_model_flops", "chip_peak_flops",
                    "mfu_cost_model", "mfu_trace", "sim_mfu_gauge", "trace_file")


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.one_of(st.none(), st.integers(-5, 50),
                 st.text(alphabet="0123456789: -+x.", max_size=8)))
def test_parse_profile_rounds_is_the_references(value):
    from fedml_tpu.obs import profiler as ref
    from fedml_tpu_torch.obs import profiler as port

    assert port.parse_profile_rounds(value) == ref.parse_profile_rounds(value)


def _aggregated(seed):
    import numpy as np

    rs = np.random.RandomState(seed)
    cats = ["fusion", "convolution", "copy-start", "infeed", "host send", "data formatting",
            "TransferToDevice", "custom-call"]
    by_cat = {c: [int(rs.randint(0, 10**12)), int(rs.randint(0, 10**9)),
                  int(rs.randint(0, 10**9)), int(rs.randint(1, 99))]
              for c in rs.choice(cats, size=rs.randint(1, len(cats)), replace=False)}
    by_src = {f"src{i}.py:{rs.randint(999)}": [int(rs.randint(0, 10**10)), int(rs.randint(0, 10**8)),
                                                int(rs.randint(0, 10**8)), int(rs.randint(1, 9))]
              for i in range(rs.randint(0, 20))}
    return {"by_category": by_cat, "by_source": by_src,
            "compile_ps": int(rs.randint(0, 10**11))}


@pytest.mark.parametrize("seed", range(8))
def test_buckets_and_rows_are_the_references(seed):
    from fedml_tpu.obs import profiler as ref
    from fedml_tpu_torch.obs import profiler as port

    agg = _aggregated(seed)
    for wall in (0.0, 0.5, 3.0, 1e4):
        assert port.split_time_buckets(agg, wall) == ref.split_time_buckets(agg, wall)
    for top in (1, 8, 12, 100):
        for bucket in ("by_category", "by_source"):
            assert port.bucket_rows(agg[bucket], top) == ref.bucket_rows(agg[bucket], top)


def test_memcpy_is_h2d_and_the_trace_is_aggregated_by_category_and_name():
    """The decided difference (the port's trace names its copies
    ``gpu_memcpy``), on a chrome trace of the port's shape."""
    from fedml_tpu.obs import profiler as ref
    from fedml_tpu_torch.obs import profiler as port

    agg = {"by_category": {"memcpy": [4 * 10**9, 0, 0, 2], "kernel": [10**9, 0, 0, 1]},
           "by_source": {}, "compile_ps": 0}
    assert port.split_time_buckets(agg, 1.0)["h2d_s"] == 0.004
    assert ref.split_time_buckets(agg, 1.0)["h2d_s"] == 0.0
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void fwd_kernel<float>(...)", "dur": 2.5},
        {"ph": "X", "cat": "kernel", "name": "void fwd_kernel<float>(...)", "dur": 1.5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "dur": 3},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "nvrtc program compile", "dur": 7},
        {"ph": "i", "cat": "kernel", "name": "instant", "dur": 9}]}
    agg = port.aggregate_device_events(trace)
    assert agg["by_category"] == {"kernel": [4 * 10**6, 0, 0, 2], "memcpy": [3 * 10**6, 0, 0, 1],
                                  "memset": [10**6, 0, 0, 1]}
    assert agg["by_source"]["void fwd_kernel<float>(...)"] == [4 * 10**6, 0, 0, 2]
    assert agg["compile_ps"] == 7 * 10**6
    buckets = port.split_time_buckets(agg, 1e-5)
    assert buckets == {"compile_s": 7e-06, "h2d_s": 3e-06, "device_compute_s": 5e-06,
                       "host_gap_s": 0.0}


def _lr_cfg(pkg, tmp_path, **extra):
    import fedml_tpu
    import fedml_tpu_torch

    top = fedml_tpu if pkg == "ref" else fedml_tpu_torch
    cfg = top.arguments.Config(
        dataset="synthetic", model="lr", client_num_in_total=4, client_num_per_round=2,
        comm_round=2, epochs=1, batch_size=8, learning_rate=0.05, synthetic_train_size=64,
        synthetic_test_size=40, partition_method="homo", frequency_of_the_test=1,
        compute_dtype="float32", random_seed=0, run_id=f"flops_{pkg}",
        data_cache_dir=str(tmp_path), extra=extra)
    return top.init(cfg)


def test_window_attribution_and_flop_count_against_the_reference(tmp_path):
    import inspect

    from fedml_tpu.obs import profiler as ref_profiler
    from fedml_tpu.obs.registry import REGISTRY as REF_REGISTRY
    from fedml_tpu.runner import FedMLRunner as RefRunner
    from fedml_tpu_torch.obs.registry import REGISTRY
    from fedml_tpu_torch.runner import FedMLRunner

    ref_src = inspect.getsource(ref_profiler.ProgramTimeAttributor._attribute)
    assert all(f'"{k}":' in ref_src for k in ATTRIBUTION_KEYS)

    prof_dir = tmp_path / "prof"
    runner = FedMLRunner(_lr_cfg("port", tmp_path, cost_model_gauges=True, profile_rounds="1:1",
                                 profile_dir=str(prof_dir)), device="cpu")
    history = runner.run()
    sim = runner.runner
    assert len(history) == 2
    att = sim.profiler.attribution
    assert att is not None and tuple(sorted(att)) == tuple(sorted(ATTRIBUTION_KEYS))
    on_disk = json.loads((prof_dir / f"sim.{os.getpid()}.attribution.json").read_text())
    assert on_disk == json.loads(json.dumps(att))
    assert att["window"]["start_round"] == 1 and att["window"]["end_round"] == 2
    assert sum(att["buckets"].values()) <= att["window"]["wall_s"] + 4e-6
    assert att["programs"] == [{"program": "sim.multi_round.1", "flops": sim.round_flops,
                                "rounds": 1}]
    assert att["chip_peak_flops"] is None and att["mfu_cost_model"] is None  # the CPU
    assert os.path.exists(att["trace_file"])
    assert REGISTRY.get("fedml_program_flops").value(program="sim.multi_round.1") == \
        sim.round_flops
    assert REGISTRY.get("fedml_sim_achieved_flops_per_sec").value() > 0
    assert REGISTRY.get("fedml_sim_mfu").value() == 0.0  # no peak on the CPU
    assert REGISTRY.get("fedml_sim_fused_blocks").value() == 0.0

    RefRunner(_lr_cfg("ref", tmp_path, cost_model_gauges=True)).run()
    ref_flops = REF_REGISTRY.get("fedml_program_flops").value(program="sim.multi_round.1")
    assert ref_flops > 0
    assert abs(sim.round_flops / ref_flops - FLOP_RATIO) <= 1e-6 * FLOP_RATIO


def test_lane_batched_round_counts_each_lane_once(tmp_path):
    """``ops/flops.flop_counter`` on a MESH round of a ResNet-20 (4 lanes,
    equal shards of 2 steps of 8): the round's count is 4 x 2 single-lane
    steps' counts within 0.5% (the lane form's layout ops count nothing;
    the first conv's input gradient is skipped in both).  torch's own
    formula counts the grouped conv's weight gradient once a lane per lane,
    4 times too often."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.ops.flops import flop_counter
    from fedml_tpu_torch.runner import FedMLRunner
    from torch.utils.flop_counter import FlopCounterMode

    cfg = fedml_tpu_torch.init(Config(
        dataset="cifar10", model="resnet20", client_num_in_total=8, client_num_per_round=4,
        comm_round=1, epochs=1, batch_size=8, synthetic_train_size=128, synthetic_test_size=16,
        partition_method="homo", frequency_of_the_test=0, compute_dtype="float32",
        data_cache_dir=str(tmp_path), extra={"cost_model_gauges": True}))
    runner = FedMLRunner(cfg, device="cpu")
    runner.run()
    sim = runner.runner
    assert sim.hp.steps_per_epoch == 2
    variables = pt.tree_map(lambda t: t.clone().requires_grad_(t.is_floating_point()),
                            sim.model.init(rng.generator(rng.init_key(rng.root_key(0)))))
    x = torch.zeros(8, 32, 32, 3)
    counts = []
    for counter in (flop_counter(), FlopCounterMode(display=False)):
        with counter:
            out, _ = sim.model.apply(variables, x, train=True)
            out.sum().backward()
        counts.append(counter.get_total_flops())
    assert counts[0] == counts[1]  # single-lane convs: the same formula
    assert abs(sim.round_flops / (4 * 2 * counts[0]) - 1) < 5e-3
    with FlopCounterMode(display=False) as plain:
        sim._backend_round(1)
    assert plain.get_total_flops() > 1.5 * sim.round_flops


@pytest.mark.parametrize("optimizer,backend", [("FedAvg", "MESH"), ("FedAvg", "sp"),
                                               ("FedSGD", "MESH"), ("Mime", "MESH")])
def test_each_rounds_flops_are_its_own_on_a_dirichlet_partition(tmp_path, optimizer, backend):
    """On the flagship's partition (Dirichlet, alpha 0.5) each round's
    clients run their own step budgets, so a round's work changes from
    round to round: every round's ``fedml_program_flops`` equals that
    round's own ``FlopCounterMode`` count (the first round's is split into
    one batch's FLOPs and the server path's), and the local-step algorithms'
    rounds differ.  FedSGD's full gradient runs every client's whole
    shard, so its rounds agree."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.obs.registry import REGISTRY
    from fedml_tpu_torch.ops.flops import flop_counter
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(Config(
        dataset="synthetic", model="lr", client_num_in_total=8, client_num_per_round=3,
        comm_round=5, epochs=1, batch_size=8, learning_rate=0.05, synthetic_train_size=240,
        synthetic_test_size=16, partition_method="hetero", partition_alpha=0.5,
        federated_optimizer=optimizer, backend_sim=backend, frequency_of_the_test=0,
        compute_dtype="float32", random_seed=0, data_cache_dir=str(tmp_path),
        extra={"cost_model_gauges": True}))
    sim = FedMLRunner(cfg, device="cpu").runner
    sim.run_rounds(1)
    assert sim.batch_flops > 0
    seen = {sim.round_flops}
    for _ in range(4):
        with flop_counter() as counter:
            sim.run_rounds(1)
        counted = counter.get_total_flops()
        assert abs(sim.round_flops - counted) <= 1e-9 * counted
        assert REGISTRY.get("fedml_program_flops").value(program="sim.multi_round.1") == \
            sim.round_flops
        seen.add(counted)
    assert (len(seen) == 1) == (optimizer == "FedSGD")


def test_engine_only_flags_refused_by_the_other_simulators(tmp_path):
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.sim.engine import MeshSimulator

    for flag, value in (("profile_rounds", "1"), ("cost_model_gauges", True)):
        cfg = fedml_tpu_torch.init(Config(
            dataset="synthetic", model="lr", federated_optimizer="decentralized_fl",
            client_num_in_total=4, client_num_per_round=4, comm_round=1,
            synthetic_train_size=64, synthetic_test_size=16, data_cache_dir=str(tmp_path),
            extra={flag: value}))
        with pytest.raises(NotImplementedError, match="served by the engine"):
            FedMLRunner(cfg, device="cpu")
    cfg = _lr_cfg("port", tmp_path, aot_programs=True)
    with pytest.raises(NotImplementedError, match="item 10b"):
        FedMLRunner(cfg, device="cpu")
    assert MeshSimulator  # the engine itself serves both flags (the test above)


def test_port_modules_load_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import fedml_tpu_torch.serving.worker, fedml_tpu_torch.obs.profiler\n"
            "import fedml_tpu_torch.ops.timing, fedml_tpu_torch.serving.deploy\n"
            "import fedml_tpu_torch.serving.gateway, fedml_tpu_torch.serving.deploy_protocol\n"
            "import fedml_tpu_torch.serving.federated, fedml_tpu_torch.ops.flops\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'fedml_tpu' or m.startswith('fedml_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stdout + out.stderr
