"""Cross-cloud FL (the port of ``fedml_tpu/cross_cloud/__init__.py``).

A cross-cloud deployment is the cross-silo protocol over a WAN transport:
the builders delegate to ``cross_silo`` with WAN defaults applied, never
over an explicit choice:

- bounded-wait straggler handling (``extra.straggler_timeout_s`` 60,
  ``straggler_quorum_frac`` 0.5), since WAN silos fail more often;
- a routable transport (TCP) for the distributed roles, where the backend
  is unset or in-process.

``training_type: cross_cloud`` (:class:`_CrossCloudRunner`, the reference's
``runner.py:65-66, 226-239``) hosts the workload the platform exists for
with ``extra.unitedllm``: silos exchange only LoRA adapters
(``llm/unitedllm.py``), with the trust features refused there as the
reference refuses them.  The in-process group runs over INPROC and, as
the cross-silo platform's does, over TCP with ``tcp_base_port: 0``.
Without it the run is the cross-silo platform's own runner
(``cross_silo.create_cross_silo_runner``), so SecAgg and FHE still reach
their secure managers.
"""

from __future__ import annotations

from .. import constants as C
from ..core.flags import cfg_extra
from ..cross_silo import _IN_PROCESS_BACKENDS, in_process_group, run_silo

_LLM_REFUSED_FLAGS = ("enable_secagg", "enable_fhe", "enable_attack", "enable_defense",
                      "enable_dp")


def _straggler_defaults(cfg):
    """WAN silos fail more than LAN ones: bounded-wait straggler handling is
    on by default (an explicit choice stays)."""
    extra = dict(getattr(cfg, "extra", {}) or {})
    extra.setdefault("straggler_timeout_s", 60.0)
    extra.setdefault("straggler_quorum_frac", 0.5)
    cfg.extra = extra
    return cfg


def _wan_defaults(cfg):
    """The straggler defaults and a routable transport for distributed
    roles."""
    cfg = _straggler_defaults(cfg)
    if not cfg.backend or cfg.backend in _IN_PROCESS_BACKENDS:
        cfg.backend = C.COMM_BACKEND_TCP
    return cfg


def refuse_llm_trust(cfg) -> None:
    """The trust features are not wired into the adapter exchange (the
    reference's refusal, word for word)."""
    active = [f for f in _LLM_REFUSED_FLAGS if getattr(cfg, f, False)]
    if active:
        raise NotImplementedError(
            f"trust features {active} are not wired into the "
            "UnitedLLM adapter-exchange path; disable them or run "
            "without extra.unitedllm"
        )


class _CrossCloudRunner:
    """The runner of ``training_type: cross_cloud`` on ``device``."""

    def __init__(self, cfg, dataset, model, device):
        self.cfg, self.dataset, self.model, self.device = cfg, dataset, model, device

    def run(self, timeout: float = 3600.0):
        cfg = self.cfg
        if cfg_extra(cfg, "unitedllm"):
            refuse_llm_trust(cfg)
            from ..llm.unitedllm import (build_unitedllm_client, build_unitedllm_server,
                                         run_unitedllm_process_group)

            if in_process_group(cfg):  # INPROC, or TCP on ports the system picks
                backend = C.COMM_BACKEND_TCP if cfg.backend == C.COMM_BACKEND_TCP else "INPROC"
                return run_unitedllm_process_group(cfg, self.dataset, self.device,
                                                   backend=backend, timeout=timeout)[0]
            _wan_defaults(cfg)
            if cfg.role == "server":
                return build_unitedllm_server(cfg, self.dataset, self.device,
                                              backend=cfg.backend).run_until_done(timeout)
            run_silo(build_unitedllm_client(cfg, self.dataset, int(cfg.rank), self.device,
                                            backend=cfg.backend), timeout)
            return None
        # the cross-silo platform itself (its builders, so SecAgg and FHE reach
        # the secure managers), the WAN defaults for distributed roles
        from ..cross_silo import create_cross_silo_runner

        return create_cross_silo_runner(cfg, self.dataset, self.model, self.device).run()


def apply_defaults(cfg) -> None:
    """The WAN defaults of a non-LLM run before its checks: the in-process
    server keeps its transport."""
    if cfg.role == "server" and cfg.backend in _IN_PROCESS_BACKENDS:
        _straggler_defaults(cfg)
    else:
        _wan_defaults(cfg)


def create_cross_cloud_runner(cfg, dataset, model, device) -> _CrossCloudRunner:
    return _CrossCloudRunner(cfg, dataset, model, device)
