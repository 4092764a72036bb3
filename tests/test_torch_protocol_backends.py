"""Port parity: every cross-silo protocol over every backend this slice
ported (``fedml_tpu_torch/cross_silo/``: the plain and buffered-async
servers, Shamir SecAgg, LightSecAgg, FHE and the edge tree, each over
MQTT_S3 on the in-memory broker, WEB3 on the in-memory ledger and GRPC on
loopback), as far as the reference's run: on the CPU, each of the
reference's groups over the backend completes its rounds
(``run_in_process_group`` and its secure counterparts), and so does the
port's.

Tolerance: the port's run over a backend against its own INPROC run of
the same protocol: bitwise for the synchronous protocols (the plain fold,
the masks cancelling exactly in the field, the FHE levels, the tree's
relays), whose result does not depend on arrival order; the async server's
virtual rounds take uploads as they land, so its history is held to its
rounds alone.
"""

import logging

import pytest
import torch

torch.set_num_threads(1)

PROTOCOLS = {
    "plain": dict(),
    "async": dict(extra={"async_aggregation": True, "async_buffer_k": 2}),
    "shamir": dict(enable_secagg=True, extra={"secagg_method": "shamir", "secagg_stream": True}),
    "lightsecagg": dict(enable_secagg=True, extra={"secagg_method": "lightsecagg"}),
    "fhe": dict(enable_fhe=True),
    "tree": dict(extra={"hier_fanout": 2}),
}
_INPROC: dict = {}


def _cfg(pkg, run_id, proto, backend, grpc_port=0):
    if pkg == "ref":
        from fedml_tpu.arguments import Config
    else:
        from fedml_tpu_torch.arguments import Config
    kw = dict(PROTOCOLS[proto])
    extra = dict(kw.pop("extra", {}))
    if backend == "GRPC":
        extra["grpc_base_port"] = grpc_port
    return Config(training_type="cross_silo", role="server", backend=backend, dataset="synthetic",
                  model="lr", client_num_in_total=4, client_num_per_round=4, comm_round=2,
                  epochs=1, batch_size=16, learning_rate=0.1, synthetic_train_size=256,
                  synthetic_test_size=64, partition_method="homo", frequency_of_the_test=1,
                  compute_dtype="float32", random_seed=0, run_id=run_id, extra=extra, **kw)


def _ref_run(proto, backend):
    import fedml_tpu
    from fedml_tpu.comm.blockchain import InMemoryLedger
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block

    cfg = _cfg("ref", f"protocols_{proto}_{backend}_ref", proto, backend,
               grpc_port=_free_port_block(8) if backend == "GRPC" else 0)
    fedml_tpu.init(cfg)
    InMemoryLedger.reset(cfg.run_id)
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num)
    if proto == "shamir":
        from fedml_tpu.cross_silo.secagg_shamir import run_shamir_secagg_process_group as run
    elif proto == "lightsecagg":
        from fedml_tpu.cross_silo.lightsecagg import run_lightsecagg_process_group as run
    elif proto == "fhe":
        from fedml_tpu.cross_silo.fhe import run_fhe_process_group as run
    else:
        from fedml_tpu.cross_silo import run_in_process_group

        return run_in_process_group(cfg, ds, model, backend=backend, timeout=60.0)
    return run(cfg, ds, model, backend=backend, timeout=60.0)[0]


def _port_run(proto, backend):
    import fedml_tpu_torch
    from fedml_tpu_torch.cross_silo import run_in_process_group
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    cfg = fedml_tpu_torch.init(_cfg("port", f"protocols_{proto}_{backend}_port", proto, backend))
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    return run_in_process_group(cfg, ds, model, "cpu", backend=backend, timeout=60.0)


def _strip(hist):
    drop = ("round_time_s", "aggregate_time_s", "finalize_time_s", "fold_time_s",
            "staleness_mean", "staleness_max")
    return [{k: v for k, v in h.items() if k not in drop} for h in hist]


@pytest.mark.parametrize("backend", ["MQTT_S3", "WEB3", "GRPC"])
@pytest.mark.parametrize("proto", sorted(PROTOCOLS))
def test_protocol_over_backend_runs_as_the_reference(proto, backend):
    logging.getLogger("fedml_tpu").setLevel(logging.WARNING)
    ref = _ref_run(proto, backend)
    assert [h["round"] for h in ref] == [0, 1]
    if proto not in _INPROC:
        _INPROC[proto] = _port_run(proto, "INPROC")
    hist = _port_run(proto, backend)
    assert [h["round"] for h in hist] == [0, 1]
    if proto != "async":
        assert _strip(hist) == _strip(_INPROC[proto])
