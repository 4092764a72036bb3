"""Both packages side by side on the cross-silo optimizers that do not
upload their full variables: SCAFFOLD, FedNova, FedDyn and Mime.

The reference builds their silos and runs, but its server fails in the
receive thread when round 0 closes: ``FedMLAggregator.aggregate``
(``fedml_tpu/cross_silo/server.py:424``) hands the algorithm the uploaded
variables, and SCAFFOLD / FedDyn / Mime read a ``'variables'`` key of
their contribution (``algorithms/scaffold.py:69``), FedNova a ``'d'``.  The
round never closes; its run waits out its timeout.  The port refuses them
up front (``cross_silo/__init__.py``, ``NotImplementedError``, before any
data is loaded).  The reference's run here is bounded by the test: it stops
its server once the receive thread has failed (30 s at most), in place of
the run's own 60 s.
"""

import logging
import threading

import pytest

from .conftest import tiny_config

#: each optimizer and the key its aggregate misses in the reference
MISSING_KEY = {"SCAFFOLD": "variables", "FedDyn": "variables", "Mime": "variables",
               "FedNova": "d"}
REFERENCE_WAIT_S = 30.0


class _FailureTap(logging.Handler):
    """Sets ``failed`` on the first record that carries an exception."""

    def __init__(self):
        super().__init__()
        self.failed = threading.Event()
        self.errors = []

    def emit(self, record):
        if record.exc_info:
            self.errors.append(record.exc_info[1])
            self.failed.set()


@pytest.mark.parametrize("opt", sorted(MISSING_KEY))
def test_cross_silo_optimizer_fails_in_the_reference_and_is_refused_by_the_port(opt):
    import fedml_tpu
    import fedml_tpu_torch.arguments as args
    from fedml_tpu.comm.inproc import InProcRouter
    from fedml_tpu.cross_silo import build_client, build_server
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub
    from fedml_tpu_torch.runner import FedMLRunner

    ref_cfg = tiny_config(training_type="cross_silo", client_num_in_total=4,
                          client_num_per_round=4, comm_round=2, role="server",
                          backend="INPROC", run_id=f"xs_opt_{opt}", federated_optimizer=opt)
    fields = {k: v for k, v in vars(ref_cfg).items() if k in args.Config.__dataclass_fields__}
    with pytest.raises(NotImplementedError, match=f"cross-silo federated_optimizer '{opt}'"):
        FedMLRunner(args.Config(**fields), device="cpu")

    fedml_tpu.init(ref_cfg)
    ds = loader.load(ref_cfg)
    model = model_hub.create(ref_cfg, ds.class_num)
    InProcRouter.reset(ref_cfg.run_id)
    clients = [build_client(ref_cfg, ds, model, rank=r, backend="INPROC") for r in range(1, 5)]
    for c in clients:
        c.run_in_thread()
    server = build_server(ref_cfg, ds, model, backend="INPROC")
    tap = _FailureTap()
    logger = logging.getLogger("fedml_tpu.comm.base")
    logger.addHandler(tap)
    box = {}
    runner = threading.Thread(
        target=lambda: box.update(h=server.run_until_done(timeout=REFERENCE_WAIT_S + 30)),
        daemon=True)
    try:
        runner.start()
        assert tap.failed.wait(REFERENCE_WAIT_S), "the reference's server did not fail"
        # the round never closes: no history, still round 0
        assert server.round_idx == 0 and not server.history
    finally:
        logger.removeHandler(tap)
        server.finish()
        server.done.set()  # release run_until_done before its own timeout
        for c in clients:
            c.finish()
        runner.join(10.0)
    assert isinstance(tap.errors[0], KeyError) and tap.errors[0].args == (MISSING_KEY[opt],)
